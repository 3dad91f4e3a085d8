"""A plain conjugate-gradient solve of K(E) u = f, preconditioned by a
geometric V-cycle: trilinear prolongation, its transpose as restriction,
coarse operators rediscretized from 2x2x2-averaged moduli (the brick's
stiffness doubles with its edge in 3-D), Chebyshev smoothing on the
Jacobi diagonal, a dense Cholesky factor on the coarsest grid.

The preconditioner only sets how fast CG converges: the answer is the
CG's on the exact fine operator, stopped at a relative residual the
caller chooses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import fem

#: the coarsest grid is factored once it has at most this many DOFs
COARSEST_DOFS = 3000


@dataclasses.dataclass
class Level:
    prob: fem.Problem
    E: torch.Tensor
    dinv: torch.Tensor
    lmax: float


def _nodes(dims) -> Tuple[int, ...]:
    return tuple(d + 1 for d in dims)


def _diagonal(prob: fem.Problem, E: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(prob.K0)
    return fem.scatter(E[..., None] * d, prob.dims)


def _sl(ax: int, s: slice):
    return (slice(None),) * ax + (s,)


def _prolong(c: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a coarse node field onto the fine nodes."""
    for ax in range(3):
        n = c.shape[ax]
        left, right = c.narrow(ax, 0, n - 1), c.narrow(ax, 1, n - 1)
        pairs = torch.stack([left, 0.5 * (left + right)], dim=ax + 1).flatten(ax, ax + 1)
        c = torch.cat([pairs, c.narrow(ax, n - 1, 1)], dim=ax)
    return c


def _restrict(f: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`_prolong`."""
    for ax in range(3):
        half = 0.5 * f[_sl(ax, slice(1, None, 2))]
        c = f[_sl(ax, slice(0, None, 2))].clone()
        n = c.shape[ax]
        c.narrow(ax, 0, n - 1).add_(half)
        c.narrow(ax, 1, n - 1).add_(half)
        f = c
    return f


def _dense(prob: fem.Problem, E: torch.Tensor) -> torch.Tensor:
    """The pinned dense K of a small grid, factored."""
    dims = prob.dims
    nodes = _nodes(dims)
    idx = torch.arange(int(np.prod(nodes)), device=E.device).reshape(nodes)
    dofs = torch.stack([3 * idx + c for c in range(3)], dim=-1)
    edofs = fem.element_dofs(dofs, dims).reshape(-1, 24)
    Ke = E.reshape(-1, 1, 1) * prob.K0
    n = 3 * idx.numel()
    K = torch.zeros(n * n, dtype=E.dtype, device=E.device)
    K.index_add_(0, (edofs[:, :, None] * n + edofs[:, None, :]).reshape(-1), Ke.reshape(-1))
    K = K.reshape(n, n)
    fixed = prob.fixed.reshape(-1)
    K[fixed, :] = 0.0
    K[:, fixed] = 0.0
    K[fixed, fixed] = 1.0
    return torch.linalg.cholesky(K)


class VCycle:
    """The V-cycle preconditioner of K(E) on ``prob``'s grid."""

    def __init__(self, prob: fem.Problem, E: torch.Tensor, matmul=torch.matmul,
                 degree: int = 3, power_iters: int = 15):
        self.matmul, self.degree = matmul, degree
        self.levels: List[Level] = []
        p, e = prob, E
        while True:
            dinv = torch.where(p.fixed, 0.0, 1.0 / _diagonal(p, e))
            lv = Level(p, e, dinv, 0.0)
            self.levels.append(lv)
            dims = p.dims
            coarse = tuple(d // 2 for d in dims)
            if (3 * int(np.prod(_nodes(dims))) <= COARSEST_DOFS
                    or any(d % 2 for d in dims)):
                break
            lv.lmax = self._lmax(lv, power_iters)
            p = dataclasses.replace(p, dims=coarse, K0=2.0 * p.K0,
                                    force=p.force[::2, ::2, ::2],
                                    fixed=p.fixed[::2, ::2, ::2])
            e = F.avg_pool3d(e[None, None], 2)[0, 0]
        last = self.levels[-1]
        self.chol = _dense(last.prob, last.E)

    def _a(self, lv: Level, u):
        return fem.free(lv.prob, fem.apply_k(lv.prob, lv.E, u, self.matmul))

    def _lmax(self, lv: Level, iters: int) -> float:
        g = torch.Generator(device=lv.E.device).manual_seed(7)
        v = fem.free(lv.prob, torch.rand(lv.dinv.shape, generator=g, device=lv.E.device,
                                         dtype=lv.E.dtype))
        lam = 1.0
        for _ in range(iters):
            w = lv.dinv * self._a(lv, v)
            lam = float(torch.linalg.vector_norm(w) / torch.linalg.vector_norm(v))
            v = w
        return lam

    def _smooth(self, lv: Level, x, b):
        hi, lo = 1.1 * lv.lmax, 0.1 * lv.lmax
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b if x is None else b - self._a(lv, x)
        d = lv.dinv * r / theta
        x = d if x is None else x + d
        for _ in range(self.degree - 1):
            r = r - self._a(lv, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + 2.0 * rho_new / delta * lv.dinv * r
            rho = rho_new
            x = x + d
        return x

    def _cycle(self, l: int, b):
        lv = self.levels[l]
        if l == len(self.levels) - 1:
            rhs = fem.free(lv.prob, b).reshape(-1, 1)
            return torch.cholesky_solve(rhs, self.chol).reshape(b.shape)
        x = self._smooth(lv, None, b)
        r = b - self._a(lv, x)
        nxt = self.levels[l + 1]
        x = x + fem.free(lv.prob, _prolong(self._cycle(l + 1, fem.free(nxt.prob, _restrict(r)))))
        return self._smooth(lv, x, b)

    def __call__(self, r):
        return self._cycle(0, r)


def solve(prob: fem.Problem, rho: torch.Tensor, tol: float, max_iter: int = 500,
          matmul=torch.matmul):
    """(u, iterations, relative residual) of K(rho) u = f by V-cycle PCG in
    ``prob``'s dtype, stopped at ||r|| <= tol ||f|| (free DOFs)."""
    E = fem.young(prob, rho.to(prob.K0.dtype))
    M = VCycle(prob, E, matmul)

    def A(v):
        return fem.free(prob, fem.apply_k(prob, E, v, matmul))

    b = fem.free(prob, prob.force)
    u = torch.zeros_like(b)
    r = b
    bn = float(torch.linalg.vector_norm(b))
    z = M(r)
    p = z
    rz = torch.sum(r * z)
    it = 0
    rel = float(torch.linalg.vector_norm(r)) / bn
    while rel > tol and it < max_iter:
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        u = u + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        rel = float(torch.linalg.vector_norm(r)) / bn
    return u, it, rel
