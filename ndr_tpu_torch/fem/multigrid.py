"""Geometric multigrid preconditioned CG on the voxel grid
(counterpart of ``ndr_tpu/fem/multigrid.py``, main-path subset).

The same hierarchy as the JAX package: 2x coarsening with Galerkin
per-element stiffnesses, Dirichlet coarsening by the boundary-face rule,
Chebyshev smoothing on D^-1 K with the guaranteed pencil bound for
lambda_max, FMG/V-cycle preconditioning, a Newton–Schulz or Cholesky
coarsest solve, and float64 iterative refinement around fp32 MGPCG.

On CUDA with kernels on, the fine level applies K through the fp32 fine
kernel, every non-coarsest cached level through
:func:`kernels.apply_k_cached_f32` from its node stencil (assembled once
per hierarchy build by :func:`kernels.cached_stencil`), and the
refinement's true residual through the float64 fine kernel. Which fine
kernels (node- or element-centric) is the ``fine_kernel`` setting, with
the JAX package's dispatch (:func:`kernels.fine_kernels`).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the multicolor Gauss-Seidel smoother, the "transfer" level kind
and a lagged preconditioner. lambda_max is the pencil bound alone, as
with the JAX default ``lmax_power_iters=0`` (power iteration is not
ported).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import FEMProblem

_TODO_GS = "ROADMAP.md Queue 1 item 11 (multicolor GS smoother)"
_TODO_LAG = "ROADMAP.md Queue 1 item 11 (lagged preconditioner)"
_TODO_TRANSFER = "ROADMAP.md Queue 1 item 11 (transfer-kind levels)"
_TODO_X64 = "ROADMAP.md Queue 2 item 6 (float64 end to end on CUDA)"
_TODO_DEGREE2 = "ROADMAP.md Queue 1 item 11 (degree-2 paths)"


# ---------------------------------------------------------------------------
# Static hierarchy setup (NumPy; copied from the JAX module, which imports jax)
# ---------------------------------------------------------------------------

def coarsen_dirichlet_mask(fine_mask: np.ndarray) -> np.ndarray:
    """Coarsen a nodal Dirichlet component mask by one 2x level (degree 1):
    coarse node j is constrained when a constrained fine node i has
    |2 j - i|_inf <= 1 (a stride-2 window-3 max). A constrained fine
    node with an all-odd index would be interior, which raises."""
    ndim = fine_mask.ndim - 1
    fine_nodes = fine_mask.shape[:-1]

    idx = np.where(fine_mask.any(axis=-1))
    if len(idx[0]):
        all_odd = np.ones(len(idx[0]), dtype=bool)
        for d in range(ndim):
            all_odd &= (idx[d] % 2) == 1
        if all_odd.any():
            raise ValueError(
                "Dirichlet constraints on internal nodes are not supported"
            )

    coarse_nodes = tuple((n - 1) // 2 + 1 for n in fine_nodes)
    out = np.zeros(coarse_nodes + fine_mask.shape[-1:], dtype=bool)
    padded = np.pad(
        fine_mask,
        [(1, 1)] * ndim + [(0, 0)],
        mode="constant",
        constant_values=False,
    )
    for off in itertools.product((0, 1, 2), repeat=ndim):
        sl = tuple(
            slice(off[d], off[d] + 2 * (coarse_nodes[d] - 1) + 1, 2)
            for d in range(ndim)
        )
        out |= padded[sl]
    return out


def _trilinear_weights(ndim: int, r, s: int) -> np.ndarray:
    """W[a, A]: coarse basis A at fine node a of the fine element at
    relative position r inside a coarse element of s^N fine elements."""
    local = np.array(list(itertools.product((0, 1), repeat=ndim)))
    W = np.zeros((len(local), len(local)))
    for a_i, a in enumerate(local):
        p = (np.asarray(r) + a) / s
        for A_i, A in enumerate(local):
            w = 1.0
            for d in range(ndim):
                w *= p[d] if A[d] == 1 else (1.0 - p[d])
            W[a_i, A_i] = w
    return W


def compressed_interpolation_phis(ndim: int) -> np.ndarray:
    """phis[fi, fine_local_node, coarse_node] for degree-1 2x coarsening;
    child ``fi`` has per-dim offset bit ``(fi >> d) & 1``."""
    n_child = 1 << ndim
    return np.stack([
        _trilinear_weights(ndim, [(fi >> d) & 1 for d in range(ndim)], 2)
        for fi in range(n_child)
    ])


def coarsened_k0s(K0: np.ndarray, ndim: int) -> np.ndarray:
    """The 2^N matrices I_fi^T K0 I_fi."""
    phis = compressed_interpolation_phis(ndim)
    npe = phis.shape[1]
    K0r = np.asarray(K0).reshape(npe, ndim, npe, ndim)
    out = np.einsum("icjd,fiI,fjJ->fIcJd", K0r, phis, phis)
    return out.reshape(phis.shape[0], npe * ndim, npe * ndim)


def deep_coarsened_k0s(K0: np.ndarray, ndim: int, level: int) -> np.ndarray:
    """C_l[r] = P_r^T K0 P_r for each fine element position r of a
    level-l coarse element, ((2^l)^N, d, d), r in C order."""
    npe = 1 << ndim
    d = npe * ndim
    K0r = np.asarray(K0).reshape(npe, ndim, npe, ndim)
    s = 1 << level
    out = np.zeros((s ** ndim, d, d))
    for ri, r in enumerate(itertools.product(range(s), repeat=ndim)):
        W = _trilinear_weights(ndim, r, s)
        out[ri] = np.einsum("acbe,aA,bB->AcBe", K0r, W, W).reshape(d, d)
    return out


def _child_w_stack(ndim: int) -> np.ndarray:
    """(2^N, npe, npe) child interpolation weights, r in C order over the
    child's position tuple."""
    return np.stack([
        _trilinear_weights(ndim, r, 2)
        for r in itertools.product((0, 1), repeat=ndim)
    ])


def _pencil_lmax_bound(stack: np.ndarray, ndim: int) -> float:
    """Density-independent upper bound on lambda_max(D^-1 K) from the
    per-element component matrices: max_c lambda_max(bd(M_c)^-1 M_c)
    (the young factors cancel; see the JAX module). Never under-estimates,
    unlike power iteration."""
    M = np.asarray(stack, np.float64)
    if M.ndim == 2:
        M = M[None]
    d = M.shape[-1]
    npe = d // ndim
    D = np.zeros_like(M)
    for a in range(npe):
        s = slice(a * ndim, (a + 1) * ndim)
        D[:, s, s] = M[:, s, s]
    vals = np.linalg.eigvals(np.linalg.solve(D, M))
    return float(vals.real.max())


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """Static per-level data."""

    grid: Grid
    dirichlet_mask: torch.Tensor        # nodes + (N,) bool, on the device


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Static multigrid configuration built once per (grid, BCs)."""

    levels: Tuple[MGLevel, ...]
    K0: np.ndarray                      # fine-level full-density Ke (f64)
    c_stacks: dict                      # {l: ((2^l)^N, d, d)} deep K0 stacks
    lmax_bounds: dict                   # {l: bound on lambda_max(D^-1 K)}
    ke_cache_limit_bytes: int = 1400 * 2**20

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def ke_bytes(self, level: int) -> int:
        d = self.K0.shape[0]
        return self.levels[level].grid.num_elements * d * d * 4

    def level_kind(self, level: int) -> str:
        if level == 0:
            return "fine"
        if level == self.num_levels - 1:
            return "cached"
        return "cached" if self.ke_bytes(level) <= self.ke_cache_limit_bytes else "transfer"


def build_mg_config(prob: FEMProblem, num_levels: int,
                    ke_cache_limit_bytes: int = 1400 * 2**20) -> MGConfig:
    """Build the static hierarchy for `num_levels` coarsenings."""
    if prob.grid.degree != 1 and num_levels > 0:
        raise NotImplementedError(
            "multigrid coarsening supports degree-1 elements; "
            "use num_levels=0 (block-Jacobi PCG) for higher degrees")
    grid = prob.grid
    mask = prob.dirichlet_mask.cpu().numpy()
    levels = [MGLevel(grid, prob.dirichlet_mask)]
    for _ in range(num_levels):
        grid = grid.coarsened()
        mask = coarsen_dirichlet_mask(mask)
        levels.append(MGLevel(grid, torch.as_tensor(mask, device=prob.device)))
    ndim = prob.grid.ndim
    K0 = prob.K0.cpu().numpy()
    c_stacks = {l: deep_coarsened_k0s(K0, ndim, l)
                for l in range(1, num_levels + 1)}
    lmax_bounds = {0: _pencil_lmax_bound(K0, ndim)}
    for l in range(1, num_levels + 1):
        lmax_bounds[l] = _pencil_lmax_bound(c_stacks[l], ndim)
    return MGConfig(
        levels=tuple(levels),
        K0=K0,
        c_stacks=c_stacks,
        lmax_bounds=lmax_bounds,
        ke_cache_limit_bytes=ke_cache_limit_bytes,
    )


# ---------------------------------------------------------------------------
# Galerkin coarse stiffness (recomputed whenever densities change)
# ---------------------------------------------------------------------------

def pooled_young(young: torch.Tensor, level: int) -> torch.Tensor:
    """(dims...) -> (coarse_dims..., (2^l)^N): the fine elements of each
    level-l coarse element, in C order over their relative position."""
    ndim = young.ndim
    s = 1 << level
    shape = []
    for n in young.shape:
        shape += [n // s, s]
    x = young.reshape(shape)
    perm = list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
    coarse = tuple(n // s for n in young.shape)
    return x.permute(perm).reshape(coarse + (s ** ndim,))


def coarsen_ke(Ke_prev: torch.Tensor, ndim: int) -> torch.Tensor:
    """One-level Galerkin coarsening of per-element stiffness matrices:
    Ke_l[e] = sum_r W_r^T Ke_{l-1}[2e+r] W_r."""
    npe = 1 << ndim
    d = npe * ndim
    dims_prev = Ke_prev.shape[:-2]
    shape = []
    for n in dims_prev:
        shape += [n // 2, 2]
    x = Ke_prev.reshape(shape + [d, d])
    perm = (list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
            + [2 * ndim, 2 * ndim + 1])
    coarse = tuple(n // 2 for n in dims_prev)
    # (coarse element q, child r, node a, comp c, node b, comp e)
    x = x.permute(perm).reshape((-1, npe, npe, ndim, npe, ndim))
    W = torch.as_tensor(_child_w_stack(ndim), dtype=Ke_prev.dtype,
                        device=Ke_prev.device)
    out = torch.einsum("qracbe,raA,rbB->qAcBe", x, W, W)
    return out.reshape(coarse + (d, d))


def build_level_ke(cfg: MGConfig, young: torch.Tensor, level: int) -> torch.Tensor:
    """Level-l Galerkin element stiffnesses directly from the fine modulus
    field: one (ne_l, R) @ (R, d*d) matmul with the deep K0 stack."""
    d = cfg.K0.shape[0]
    C = torch.as_tensor(cfg.c_stacks[level], dtype=young.dtype,
                        device=young.device)                   # (R, d, d)
    pooled = pooled_young(young, level)                        # (dims_l..., R)
    Ke = pooled.reshape(-1, C.shape[0]) @ C.reshape(C.shape[0], d * d)
    return Ke.reshape(pooled.shape[:-1] + (d, d))


# ---------------------------------------------------------------------------
# Transfer operators (degree-1 separable [1/2, 1, 1/2] stencils)
# ---------------------------------------------------------------------------

def _sl(ndim_total: int, axis: int, s: slice) -> Tuple[slice, ...]:
    return tuple(s if a == axis else slice(None) for a in range(ndim_total))


def _prolong_axis(u: torch.Tensor, axis: int) -> torch.Tensor:
    n = u.shape[axis]
    out_shape = list(u.shape)
    out_shape[axis] = 2 * n - 1
    out = u.new_zeros(out_shape)
    nd = u.ndim
    out[_sl(nd, axis, slice(0, None, 2))] = u
    out[_sl(nd, axis, slice(1, None, 2))] = 0.5 * (
        u[_sl(nd, axis, slice(0, n - 1))] + u[_sl(nd, axis, slice(1, n))])
    return out


def _restrict_axis(r: torch.Tensor, axis: int) -> torch.Tensor:
    nd = r.ndim
    even = r[_sl(nd, axis, slice(0, None, 2))]
    odd = r[_sl(nd, axis, slice(1, None, 2))]
    zero_shape = list(odd.shape)
    zero_shape[axis] = 1
    zero = odd.new_zeros(zero_shape)
    return even + 0.5 * (torch.cat([zero, odd], axis)
                         + torch.cat([odd, zero], axis))


def prolongate(u_coarse: torch.Tensor, ndim: int) -> torch.Tensor:
    """Interpolate a coarse node field to the fine grid (I u_c)."""
    out = u_coarse
    for axis in range(ndim):
        out = _prolong_axis(out, axis)
    return out


def restrict(r_fine: torch.Tensor, ndim: int) -> torch.Tensor:
    """Apply the transposed interpolation operator (I^T r_f)."""
    out = r_fine
    for axis in range(ndim):
        out = _restrict_axis(out, axis)
    return out


# ---------------------------------------------------------------------------
# Per-solve level state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelState:
    """Per-level operators for one density configuration.

    kind "fine": matrix-free apply from the SIMP modulus field;
    kind "cached": the Galerkin operator materialized — as the
    per-element stack ``Ke`` (dims..., d, d), or, where the cached-level
    kernel serves the level, only as the assembled node ``stencil``
    (:func:`kernels.stencil_shape`, 3^N N^2 values per node; never both:
    either is the level's largest array).
    """

    grid: Grid
    dirichlet_mask: torch.Tensor
    young: Optional[torch.Tensor]       # level 0 only
    Ke: Optional[torch.Tensor]          # cached levels without a stencil
    Minv_rows: torch.Tensor             # nodes + (N, N) diag blocks of K
    K0: Optional[torch.Tensor]          # level 0 only, in young's dtype
    Dinv: Optional[torch.Tensor] = None
    lmax: Optional[float] = None
    kind: str = "cached"
    stencil: Optional[torch.Tensor] = None
    # level 0 with kernels: the fp32 apply and the float64 residual's apply
    # that the ``fine_kernel`` setting names (kernels.fine_kernels)
    fine_apply: Optional[Callable] = None
    fine_apply64: Optional[Callable] = None


def _apply_k_level(lv: LevelState, u: torch.Tensor) -> torch.Tensor:
    if lv.kind == "fine":
        if lv.fine_apply is not None:
            return lv.fine_apply(u, lv.young, lv.K0, lv.grid)
        return ops.apply_k(u, lv.young, lv.K0, lv.grid)
    if lv.stencil is not None:
        return kernels.apply_k_cached_f32(u, lv.stencil, lv.grid)
    return ops.apply_k_cached(u, lv.Ke, lv.grid)


def _zero_dirichlet(lv: LevelState, u: torch.Tensor) -> torch.Tensor:
    return u.masked_fill(lv.dirichlet_mask, 0.0)


def build_level_states(
    cfg: MGConfig, prob: FEMProblem, young: torch.Tensor,
    smoother: str = "chebyshev", use_kernels: bool = False,
    fine_kernel: str = "flat32",
) -> List[LevelState]:
    """The hierarchy's operators for one modulus field.

    ``use_kernels`` routes the fine level (through the fp32 kernel that
    ``fine_kernel`` names) and every non-coarsest cached level through the
    CUDA kernels, which take fp32 degree-1 hierarchies.
    On CUDA tensors any other hierarchy raises rather than run the plain
    ops on the card; on CPU tensors the plain ops serve it (the wrappers
    run their plain twins there anyway)."""
    if smoother != "chebyshev":
        raise NotImplementedError(f"smoother={smoother!r}: {_TODO_GS}")
    apply32, apply64 = kernels.fine_kernels(fine_kernel)
    degree = cfg.levels[0].grid.degree
    if use_kernels and young.device.type == "cuda":
        if young.dtype != torch.float32:
            raise NotImplementedError(
                f"CUDA kernels on a {young.dtype} hierarchy: only the fp32 "
                f"hierarchy has kernels ({_TODO_X64})")
        if degree != 1:
            raise NotImplementedError(
                f"CUDA kernels on degree-{degree} elements: {_TODO_DEGREE2}")
    use_kernels = use_kernels and young.dtype == torch.float32 and degree == 1
    states = []
    last = cfg.num_levels - 1
    prev_ke = None
    for l, lev in enumerate(cfg.levels):
        kind = cfg.level_kind(l)
        if kind == "transfer":
            raise NotImplementedError(
                f"level {l} Ke exceeds ke_cache_limit_bytes: {_TODO_TRANSFER}")
        Ke = stencil = None
        if l == 0:
            M = ops.node_diag_blocks(young, prob.K0, lev.grid)
        else:
            if prev_ke is not None and l >= 2:
                # recursive Galerkin from the finer cached level
                Ke = coarsen_ke(prev_ke, lev.grid.ndim)
            else:
                Ke = build_level_ke(cfg, young, l)
            M = ops.node_diag_blocks_cached(Ke, lev.grid)
            prev_ke = Ke
            if use_kernels and l != last:
                # prev_ke keeps the stack for the next level's coarsen_ke
                stencil = kernels.cached_stencil(Ke.contiguous(), lev.grid)
                Ke = None
        states.append(
            LevelState(
                grid=lev.grid,
                dirichlet_mask=lev.dirichlet_mask,
                young=young if l == 0 else None,
                Ke=Ke,
                Minv_rows=M,
                K0=prob.K0.to(young.dtype) if l == 0 else None,
                kind=kind,
                stencil=stencil,
                fine_apply=apply32 if use_kernels and l == 0 else None,
                fine_apply64=apply64 if use_kernels and l == 0 else None,
            )
        )
    for l, lv in enumerate(states):
        lv.Dinv = ops.invert_blocks(lv.Minv_rows)
        lv.lmax = cfg.lmax_bounds[l]
    return states


def _dinv_apply(lv: LevelState, r: torch.Tensor) -> torch.Tensor:
    z = (lv.Dinv * r.unsqueeze(-2)).sum(-1)
    return _zero_dirichlet(lv, z)


def chebyshev_core(apply_fn, dinv_fn, zero_fn, lmax, x, b, degree: int,
                   lower_frac: float = 0.25, x_is_zero: bool = False,
                   need_r: bool = False):
    """Degree-`degree` Chebyshev smoothing on D^-1 K over
    [lower_frac*lmax, lmax]. Returns ``(x, r)``; ``r = b - K x`` comes
    free when ``need_r`` (else ``None``), and ``x_is_zero`` skips the
    initial apply."""
    # scalar coefficients in the working dtype, as the JAX package
    # evaluates them (its lmax is an array of the level's dtype)
    st = np.float32 if b.dtype == torch.float32 else np.float64
    lmax = st(lmax)
    lmin = st(lower_frac) * lmax
    theta = st(0.5) * (lmax + lmin)
    delta = st(0.5) * (lmax - lmin)
    sigma1 = theta / delta

    r = b if x_is_zero else zero_fn(b - apply_fn(x))
    z = dinv_fn(r)
    d = z / float(theta)
    rho = st(1.0) / sigma1
    for _ in range(degree - 1):
        x = x + d
        r = zero_fn(r - apply_fn(d))
        z = dinv_fn(r)
        rho_new = st(1.0) / (st(2.0) * sigma1 - rho)
        d = float(rho_new * rho) * d + float(st(2.0) * rho_new / delta) * z
        rho = rho_new
    x = x + d
    if not need_r:
        return x, None
    return x, zero_fn(r - apply_fn(d))


def chebyshev_smooth(lv: LevelState, x, b, degree: int,
                     lower_frac: float = 0.25, x_is_zero: bool = False,
                     need_r: bool = False):
    """Chebyshev smoothing on a LevelState; returns ``(x, r)`` (see
    :func:`chebyshev_core`)."""
    return chebyshev_core(
        lambda v: _apply_k_level(lv, v),
        lambda r: _dinv_apply(lv, r),
        lambda v: _zero_dirichlet(lv, v),
        lv.lmax, x, b, degree, lower_frac=lower_frac, x_is_zero=x_is_zero,
        need_r=need_r,
    )


# ---------------------------------------------------------------------------
# Coarsest solve
# ---------------------------------------------------------------------------

def _coarse_solve(lv: LevelState, coarse, b):
    """Coarsest-level solve: Cholesky factor or precomputed NS inverse."""
    kind, data = coarse
    rhs = b.reshape(-1).masked_fill(lv.dirichlet_mask.reshape(-1), 0.0)
    if kind == "ns":
        x = data @ rhs
    else:
        x = torch.cholesky_solve(rhs[:, None], data)[:, 0]
    return x.reshape(b.shape)


def _coarsest_dense_k(levels: List[LevelState]) -> torch.Tensor:
    """The pinned, Tikhonov-shifted dense K of the coarsest level,
    modified in place (one n_dofs^2 buffer)."""
    lv = levels[-1]
    K = solvers.assemble_dense_k_traced(lv.Ke, lv.grid)
    idx = torch.nonzero(lv.dirichlet_mask.reshape(-1)).reshape(-1)
    K[idx, :] = 0.0
    K[:, idx] = 0.0
    K[idx, idx] = 1.0
    # relative diagonal shift, decisively above the fp32 Galerkin
    # rounding floor (see ndr_tpu.fem.multigrid._coarsest_dense_k): the
    # coarse solve only preconditions, and an indefinite fp32 coarse K
    # would NaN the Cholesky
    eps = 1e-4 if K.dtype == torch.float32 else 1e-12
    diag = K.diagonal()
    diag.add_(eps * diag)
    return K


def factor_coarsest(levels: List[LevelState], method: str = "cholesky"):
    """("chol", L) with the lower Cholesky factor, or ("ns", X) with a
    Jacobi-scaled Newton–Schulz inverse."""
    K = _coarsest_dense_k(levels)
    if method == "cholesky":
        return ("chol", torch.linalg.cholesky(K))
    if method != "ns":
        raise ValueError(f"coarse solver {method!r}")
    return ("ns", ns_inverse(K))


def ns_inverse(K: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Jacobi-scaled Newton–Schulz inverse of a dense SPD matrix; the
    result is symmetric PD, so the MG preconditioner stays PCG-safe."""
    d = torch.diagonal(K)
    s = torch.rsqrt(d)
    Khat = (K * s[:, None]) * s[None, :]
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    norm1 = torch.max(torch.sum(torch.abs(Khat), dim=1))
    X = eye * (1.0 / norm1)
    for _ in range(iters):
        X = X @ (2.0 * eye - Khat @ X)
    return (s[:, None] * X) * s[None, :]


# ---------------------------------------------------------------------------
# Cycles
# ---------------------------------------------------------------------------

def _smooth(lv: LevelState, x, b, nsmooth: int, cheb_degree: int,
            x_is_zero: bool = False, need_r: bool = False):
    return chebyshev_smooth(lv, x, b, degree=cheb_degree * nsmooth,
                            x_is_zero=x_is_zero, need_r=need_r)


def vcycle(levels, chol, l, x, b, nsmooth: int, cheb_degree: int = 2,
           x_zero: bool = False):
    if l == len(levels) - 1:
        return _coarse_solve(levels[l], chol, b)
    lv = levels[l]
    x = x if x_zero else _zero_dirichlet(lv, x)
    x, r = _smooth(lv, x, b, nsmooth, cheb_degree, x_is_zero=x_zero,
                   need_r=True)
    b_c = restrict(r, lv.grid.ndim)
    x_c = vcycle(levels, chol, l + 1, torch.zeros_like(b_c), b_c, nsmooth,
                 cheb_degree, x_zero=True)
    x = x + prolongate(x_c, lv.grid.ndim)
    x, _ = _smooth(lv, x, b, nsmooth, cheb_degree)
    return x


def full_multigrid(levels, chol, l, b, nsmooth: int, cheb_degree: int = 2):
    if l == len(levels) - 1:
        return _coarse_solve(levels[l], chol, b)
    b_c = restrict(b, levels[l].grid.ndim)
    x_c = full_multigrid(levels, chol, l + 1, b_c, nsmooth, cheb_degree)
    x = prolongate(x_c, levels[l].grid.ndim)
    return vcycle(levels, chol, l, x, b, nsmooth, cheb_degree)


def mg_preconditioner(levels, chol, r, mg_iterations: int, nsmooth: int,
                      fmg: bool, cheb_degree: int = 2):
    """s ~= K^-1 r."""
    if fmg:
        s = full_multigrid(levels, chol, 0, r, nsmooth, cheb_degree)
        for _ in range(mg_iterations - 1):
            s = vcycle(levels, chol, 0, s, r, nsmooth, cheb_degree)
    else:
        s = torch.zeros_like(r)
        for k in range(mg_iterations):
            s = vcycle(levels, chol, 0, s, r, nsmooth, cheb_degree,
                       x_zero=(k == 0))
    return s


# ---------------------------------------------------------------------------
# MGPCG driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MGSolverSettings:
    """Solver knobs, with ``ndr_tpu.fem.multigrid.MGSolverSettings``'s
    defaults. ``smoother="gs"`` is the JAX default but is not ported yet
    (it raises); the classic driver passes "chebyshev"."""

    num_levels: int = 2
    cg_iter: int = 100
    tol: float = 1e-4
    mg_iterations: int = 1
    mg_smoothing_iterations: int = 2
    full_multigrid: bool = True
    zero_init: bool = False
    smoother: str = "gs"
    cheb_degree: int = 2
    # float64 iterative refinement around the fp32 MGPCG (float32
    # problems): the true residual is measured in float64
    mixed_precision: bool = True
    max_refinements: int = 6
    # CUDA kernels: True/False or "auto" (= on for CUDA tensors)
    use_kernels: object = "auto"
    ke_cache_limit_bytes: int = 1400 * 2**20
    # "mg" = multigrid preconditioner; "jacobi" = block-Jacobi PCG
    precond: str = "mg"
    # coarsest solve: "cholesky", "ns" or "auto" (ns for fp32
    # hierarchies up to NS_AUTO_MAX_DOFS, else cholesky)
    coarse_solver: str = "auto"
    # fine-level kernels with use_kernels: "flat32" (fine_stream.cu's
    # streamed apply in fp32 and for the float64 residual), "variant"
    # (fine_elem.cu's element-centric fp32) or "flat" (element-centric
    # float64 residual); the JAX package's NDR_FINE_KERNEL switch
    fine_kernel: str = "flat32"


# "auto" coarse-solver size gate (Newton–Schulz costs ~30 dense n^3
# matmul pairs per hierarchy build, so it only pays on small systems)
NS_AUTO_MAX_DOFS = 1536


def _resolve_coarse_solver(settings: MGSolverSettings,
                           levels: List[LevelState]) -> str:
    if settings.coarse_solver != "auto":
        return settings.coarse_solver
    lv = levels[-1]
    if lv.Ke.dtype != torch.float32:
        return "cholesky"
    ndofs = lv.grid.num_nodes * lv.grid.ndim
    return "ns" if ndofs <= NS_AUTO_MAX_DOFS else "cholesky"


def resolve_use_kernels(setting, device: torch.device) -> bool:
    """``"auto"`` means on for CUDA tensors; True/False are explicit."""
    if setting == "auto":
        return torch.device(device).type == "cuda"
    return bool(setting)


def _use_refined(prob: FEMProblem, settings: MGSolverSettings) -> bool:
    return settings.mixed_precision and prob.force.dtype == torch.float32


def _make_preconditioner(cfg, settings, levels):
    lv0 = levels[0]
    if settings.precond == "jacobi":
        def precond(r):
            return _dinv_apply(lv0, r)
    else:
        chol = factor_coarsest(levels, _resolve_coarse_solver(settings, levels))

        def precond(r):
            s = mg_preconditioner(
                levels, chol, r, settings.mg_iterations,
                settings.mg_smoothing_iterations, settings.full_multigrid,
                settings.cheb_degree,
            )
            return _zero_dirichlet(lv0, s)
    return precond


def mgpcg_solve(
    cfg: MGConfig,
    prob: FEMProblem,
    rho: torch.Tensor,
    u0: Optional[torch.Tensor],
    settings: MGSolverSettings,
    precond_state=None,
) -> Tuple[torch.Tensor, int]:
    """Full MGPCG equilibrium solve K(rho) u = f: rebuild the Galerkin
    hierarchy for ``rho``, factor the coarsest level, run PCG from the
    warm start. Float32 problems with ``settings.mixed_precision`` run as
    float64 iterative refinement around the fp32 MGPCG."""
    if precond_state is not None:
        raise NotImplementedError(f"precond_state: {_TODO_LAG}")
    if _use_refined(prob, settings):
        return _mgpcg_solve_refined(cfg, prob, rho, u0, settings)
    young = prob.young(rho)
    levels = build_level_states(
        cfg, prob, young, smoother=settings.smoother,
        use_kernels=resolve_use_kernels(settings.use_kernels, prob.device),
        fine_kernel=settings.fine_kernel)
    lv0 = levels[0]

    def apply_a(u):
        return _zero_dirichlet(lv0, _apply_k_level(lv0, _zero_dirichlet(lv0, u)))

    precond = _make_preconditioner(cfg, settings, levels)
    b = _zero_dirichlet(lv0, prob.force)
    if u0 is None or settings.zero_init:
        u0 = torch.zeros_like(b)
    u0 = _zero_dirichlet(lv0, u0.to(b.dtype))
    return solvers.conjugate_gradient(
        apply_a, b, u0, tol=settings.tol, max_iter=settings.cg_iter,
        precond=precond)


def _mgpcg_solve_refined(
    cfg: MGConfig,
    prob: FEMProblem,
    rho: torch.Tensor,
    u0: Optional[torch.Tensor],
    settings: MGSolverSettings,
) -> Tuple[torch.Tensor, int]:
    """Float64 iterative refinement around the fp32 MGPCG.

    Outer loop (float64): r = b - K u with the exact float64 operator;
    stop when ||r|| <= tol * ||b||. Inner loop: fp32 MGPCG on the
    correction system, targeting the final tolerance directly, with a
    second pass only when the needed reduction exceeds what one fp32
    solve can deliver (cold starts). With kernels on, the float64
    residual is the float64 fine kernel of ``settings.fine_kernel`` at
    every tol.
    """
    f32, f64 = torch.float32, torch.float64
    young32 = prob.young(rho).to(f32)
    levels = build_level_states(
        cfg, prob, young32, smoother=settings.smoother,
        use_kernels=resolve_use_kernels(settings.use_kernels, prob.device),
        fine_kernel=settings.fine_kernel)
    lv0 = levels[0]

    K0_64 = prob.K0.to(f64)
    young64 = ops.element_young_modulus(
        rho.to(f64), prob.E0, prob.Emin, prob.gamma)
    force64 = prob.force.to(f64)
    apply64 = lv0.fine_apply64 or ops.apply_k

    def residual64(u):
        return _zero_dirichlet(lv0, force64 - apply64(u, young64, K0_64, lv0.grid))

    def apply_a32(v):
        return _zero_dirichlet(lv0, _apply_k_level(lv0, _zero_dirichlet(lv0, v)))

    precond32 = _make_preconditioner(cfg, settings, levels)

    b64 = _zero_dirichlet(lv0, force64)
    b_norm = torch.linalg.norm(b64.reshape(-1)).item()
    if u0 is None or settings.zero_init:
        u = torch.zeros_like(b64)
    else:
        u = _zero_dirichlet(lv0, u0.to(f64))

    fp32_floor = 5e-4  # smallest reduction one fp32 CG pass can deliver
    r = residual64(u)
    done, total_iters, k = False, 0, 0
    while not done and k < settings.max_refinements:
        rn = max(torch.linalg.norm(r.reshape(-1)).item(), 1e-300)
        needed = settings.tol * b_norm / rn
        inner_tol = torch.tensor(float(np.clip(0.5 * needed, fp32_floor, 0.9)),
                                 dtype=f32, device=u.device)
        e32, iters = solvers.conjugate_gradient(
            apply_a32, r.to(f32), torch.zeros(r.shape, dtype=f32, device=u.device),
            tol=inner_tol, max_iter=settings.cg_iter, precond=precond32,
        )
        u = u + e32.to(f64)
        # an unclipped target means the correction solve's own stop test
        # already implies the outer tolerance: no float64 residual needed
        done = 0.5 * needed >= fp32_floor
        if not done:
            r = residual64(u)
        total_iters += iters
        k += 1
    return u, total_iters


def max_feasible_coarsenings(grid: Grid) -> int:
    """How many 2x coarsenings the grid admits (all dims even each time)."""
    if grid.degree != 1:
        return 0
    n, dims = 0, grid.dims
    while all(d % 2 == 0 and d >= 2 for d in dims):
        dims = tuple(d // 2 for d in dims)
        n += 1
    return n


def make_mg_solver(prob: FEMProblem, settings: MGSolverSettings):
    """Returns a SolveFn (rho, u0) -> (u, iters) closure for topopt.

    Requested coarsenings are clamped to what the grid admits; a grid
    that cannot coarsen at all falls back to block-Jacobi PCG.
    """
    nl = min(settings.num_levels, max_feasible_coarsenings(prob.grid))
    if settings.precond == "jacobi" or nl == 0:
        settings = dataclasses.replace(settings, precond="jacobi", num_levels=0)
        nl = 0
    elif nl != settings.num_levels:
        settings = dataclasses.replace(settings, num_levels=nl)
    cfg = build_mg_config(prob, nl,
                          ke_cache_limit_bytes=settings.ke_cache_limit_bytes)

    def solve(rho, u0=None, precond=None):
        return mgpcg_solve(cfg, prob, rho, u0, settings, precond_state=precond)

    solve.cfg = cfg
    solve.settings = settings
    return solve
