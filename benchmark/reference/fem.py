"""Plain finite elements of the voxel elasticity problem, written from the
problem's definition alone: trilinear hexahedra, an isotropic material,
boundary regions given as fractions of the domain's box, the SIMP law.

Nothing here comes from the program: the problem is rebuilt from the
benchmark's own configuration file, and every array is computed in the
dtype asked for (float64 for judging).

Conventions the program's outputs use, and so the judge too:
  * element fields have shape ``dims``; node fields ``dims + 1`` per axis
    with a trailing component axis of 3;
  * an element's local nodes are ordered (i, j, k) over {0, 1}^3 with the
    last index fastest, and its DOFs node-major, component-minor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

CORNERS = tuple(itertools.product((0, 1), repeat=3))


@dataclasses.dataclass
class Problem:
    """The elasticity problem on one grid, as tensors on one device."""

    dims: Tuple[int, int, int]
    K0: torch.Tensor          # (24, 24) full-density element stiffness
    force: torch.Tensor       # nodes + (3,)
    fixed: torch.Tensor       # bool, nodes + (3,): Dirichlet components
    E0: float
    Emin: float
    penalty: float
    volume: float             # the target volume fraction

    def to(self, dtype) -> "Problem":
        return dataclasses.replace(self, K0=self.K0.to(dtype), force=self.force.to(dtype))


def element_stiffness(h: Sequence[float], young: float, poisson: float) -> np.ndarray:
    """K0 of a trilinear brick with edges ``h``, by 2x2x2 Gauss quadrature
    of B^T D B in Voigt notation (engineering shear strains)."""
    lam = poisson * young / ((1 + poisson) * (1 - 2 * poisson))
    mu = young / (2 * (1 + poisson))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[:3, :3] += 2 * mu * np.eye(3)
    D[3:, 3:] = mu * np.eye(3)
    g = (0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0))
    K = np.zeros((24, 24))
    vol = float(np.prod(h))
    for q in itertools.product(g, repeat=3):
        B = np.zeros((6, 24))
        for a, c in enumerate(CORNERS):
            # d/dx_d of prod_e (c_e ? t_e : 1 - t_e), divided by the edge
            grad = []
            for d in range(3):
                v = 1.0 / h[d] * (1.0 if c[d] else -1.0)
                for e in range(3):
                    if e != d:
                        v *= q[e] if c[e] else 1.0 - q[e]
                grad.append(v)
            gx, gy, gz = grad
            col = 3 * a
            B[0, col] = gx
            B[1, col + 1] = gy
            B[2, col + 2] = gz
            B[3, col + 1], B[3, col + 2] = gz, gy    # yz
            B[4, col], B[4, col + 2] = gz, gx        # xz
            B[5, col], B[5, col + 1] = gy, gx        # xy
        K += B.T @ D @ B * (vol / 8.0)
    return 0.5 * (K + K.T)


def build_problem(config: dict, dtype=torch.float64, device="cuda") -> Problem:
    """The problem of a benchmark configuration file: its grid, domain,
    material, boundary regions and SIMP parameters."""
    p = config["problem"]
    dims = tuple(int(d) for d in config["grid"])
    lo = np.asarray(p["domainCorners"][0], dtype=np.float64)
    hi = np.asarray(p["domainCorners"][1], dtype=np.float64)
    size = hi - lo
    axes = [np.linspace(lo[d], hi[d], dims[d] + 1) for d in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    fixed = np.zeros(pts.shape, dtype=bool)
    force = np.zeros(pts.shape, dtype=np.float64)
    for reg in p["bc"]["regions"]:
        a = lo + np.asarray(reg["box%"]["minCorner"], dtype=np.float64) * size
        b = lo + np.asarray(reg["box%"]["maxCorner"], dtype=np.float64) * size
        inside = np.all((pts >= a) & (pts <= b), axis=-1)
        n = int(inside.sum())
        if n == 0:
            raise ValueError(f"boundary region with no node: {reg}")
        kind = reg["type"]
        if kind == "force":
            force += inside[..., None] * (np.asarray(reg["value"], dtype=np.float64) / n)
        elif kind.startswith("dirichlet"):
            comps = kind[len("dirichlet"):] or "xyz"
            if any(float(v) != 0.0 for v in reg["value"]):
                raise ValueError("only zero displacements are imposed")
            for ch in comps:
                fixed[..., "xyz".index(ch)] |= inside
        else:
            raise ValueError(f"unknown boundary region {kind!r}")
    mat = p["material"]
    K0 = element_stiffness(size / np.asarray(dims, dtype=np.float64),
                           float(mat["young"]), float(mat["poisson"]))
    return Problem(
        dims=dims,
        K0=torch.tensor(K0, dtype=dtype, device=device),
        force=torch.tensor(force, dtype=dtype, device=device),
        fixed=torch.tensor(fixed, device=device),
        E0=float(p["E0"]), Emin=float(p["Emin"]), penalty=float(p["SIMPExponent"]),
        volume=float(p["maxVolume"][0]),
    )


def young(prob: Problem, rho: torch.Tensor) -> torch.Tensor:
    """SIMP: E = Emin + rho^p (E0 - Emin)."""
    return prob.Emin + rho ** prob.penalty * (prob.E0 - prob.Emin)


def _corner(c, dims):
    return tuple(slice(c[d], c[d] + dims[d]) for d in range(3))


def element_dofs(u: torch.Tensor, dims) -> torch.Tensor:
    """The 24 DOFs of every element, dims + (24,)."""
    return torch.cat([u[_corner(c, dims)] for c in CORNERS], dim=-1)


def scatter(F: torch.Tensor, dims) -> torch.Tensor:
    """Sum element forces dims + (24,) into a node field."""
    out = torch.zeros(tuple(d + 1 for d in dims) + (3,), dtype=F.dtype, device=F.device)
    for a, c in enumerate(CORNERS):
        out[_corner(c, dims)] += F[..., 3 * a:3 * a + 3]
    return out


def apply_k(prob: Problem, E: torch.Tensor, u: torch.Tensor, matmul=torch.matmul,
            slab: int = 32) -> torch.Tensor:
    """K(E) u, element by element, in slabs of ``slab`` element layers along x
    so that the element arrays stay small. ``matmul`` computes the element
    products (the control passes one of lower precision)."""
    dims = prob.dims
    out = torch.zeros_like(u)
    K0 = prob.K0.to(u.dtype)
    for x0 in range(0, dims[0], slab):
        n = min(slab, dims[0] - x0)
        sub = (n,) + tuple(dims[1:])
        U = element_dofs(u[x0:x0 + n + 1], sub)
        F = matmul(U, K0) * E[x0:x0 + n, ..., None].to(u.dtype)
        out[x0:x0 + n + 1] += scatter(F, sub)
    return out


def free(prob: Problem, v: torch.Tensor) -> torch.Tensor:
    """v with its Dirichlet components set to zero."""
    return v.masked_fill(prob.fixed, 0.0)


def residual(prob: Problem, rho: torch.Tensor, u: torch.Tensor) -> float:
    """||f - K(rho) u|| / ||f|| over the free DOFs, in u's dtype."""
    f = free(prob, prob.force.to(u.dtype))
    r = f - free(prob, apply_k(prob, young(prob, rho.to(u.dtype)), free(prob, u)))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f))


def energy_density(prob: Problem, u: torch.Tensor, matmul=torch.matmul,
                   slab: int = 32) -> torch.Tensor:
    """u_e^T K0 u_e of every element, in the dtype ``matmul`` returns (u is
    rounded to it first)."""
    dims = prob.dims
    K0 = prob.K0.to(u.dtype)
    out = []
    for x0 in range(0, dims[0], slab):
        n = min(slab, dims[0] - x0)
        U = element_dofs(u[x0:x0 + n + 1], (n,) + tuple(dims[1:]))
        KU = matmul(U, K0)
        out.append((KU * U.to(KU.dtype)).sum(-1))
    return torch.cat(out)


def compliance_grad_rho(prob: Problem, rho: torch.Tensor, u: torch.Tensor,
                        matmul=torch.matmul) -> torch.Tensor:
    """d(f^T u)/d(rho) at equilibrium: -p rho^(p-1) (E0 - Emin) u_e^T K0 u_e."""
    ue = energy_density(prob, u, matmul).to(rho.dtype)
    return -prob.penalty * rho ** (prob.penalty - 1) * (prob.E0 - prob.Emin) * ue
