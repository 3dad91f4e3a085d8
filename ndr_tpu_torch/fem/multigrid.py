"""Geometric multigrid preconditioned CG on the voxel grid
(counterpart of ``ndr_tpu/fem/multigrid.py``).

The same hierarchy as the JAX package: 2x coarsening with Galerkin
per-element stiffnesses, Dirichlet coarsening by the boundary-face rule,
multicolor Gauss-Seidel or Chebyshev smoothing (on D^-1 K with the
guaranteed pencil bound for lambda_max), FMG/V-cycle preconditioning, a
Newton–Schulz or Cholesky coarsest solve, and float64 iterative
refinement around fp32 MGPCG. A level whose Galerkin Ke would exceed
``ke_cache_limit_bytes`` is a "transfer" level, applied as R K_finer P.

On CUDA with kernels on, the fine level applies K through the fp32 fine
kernel, every non-coarsest cached level through
:func:`kernels.apply_k_cached` from its node stencil (assembled once per
hierarchy build by :func:`kernels.cached_stencil`, or in bf16 under
``cached_ke_dtype="bfloat16"``), and the refinement's true residual
through the float64 fine kernel. A float64 hierarchy applies level 0
with the float64 fine kernel and its cached levels from float64 stencils
(:func:`kernels.cached_stencil_f64`). Which fine kernels (node- or
element-centric) is the ``fine_kernel`` setting, with the JAX package's
dispatch (:func:`kernels.fine_kernels`). The kernels take degree-1
grids: ``use_kernels="auto"`` resolves to the plain applies on another
degree, as the JAX package takes XLA there. The GS sweep itself is torch
ops: each colour is updated on its own stride-2 sub-lattice, and its
residual update K du reads only what touches that colour
(:func:`apply_k_parity`). lambda_max is the pencil bound, or with
``lmax_power_iters`` the smaller of it and an inflated power estimate.

A lagged preconditioner (:class:`PrecondState`, ``solve.build_precond``)
is a hierarchy built at an earlier density: the CG operator always uses
the current one, the state only preconditions. Under the trainers'
chunked loops on CUDA its preconditioner call is replayed from a CUDA
graph (:class:`PrecondGraph`), the port's counterpart of the JAX
package's device-side ``lax.scan`` loop; rebuilds write into the
captured tensors in place, so one capture serves a run.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import FEMProblem
from ndr_tpu_torch.utils import timers

SMOOTHERS = ("gs", "chebyshev")
#: Storage types of the intermediate cached levels (``cached_ke_dtype``).
CACHED_KE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}

#: The port's counter registry (``timers.counters``, the same dict): here,
#: since the last :func:`reset_stats`, hierarchy builds, the
#: preconditioner's CUDA graphs (captures, replays, capture seconds, the
#: latter the ``mg.graph_capture`` span's), the CG iterations of every pass
#: (``cg_iters``) and the passes that stopped at their iteration cap
#: (``cg_iter``) rather than at the tolerance; beside them the spans'
#: times and the other counters of the port.
stats: Dict[str, float] = timers.counters
for _k, _zero in (("hierarchy_builds", 0), ("graph_captures", 0), ("graph_replays", 0),
                  ("graph_capture_seconds", 0.0), ("cg_passes_at_cap", 0),
                  ("cg_iters", 0)):
    stats.setdefault(_k, _zero)


def reset_stats() -> None:
    """Zero the registry in place (:func:`timers.reset`)."""
    timers.reset()


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


def parity_colors(grid: Grid) -> Tuple[Tuple[int, ...], ...]:
    """The (degree+1)^N node colour classes of the multicolor GS sweep,
    each as the residue of a node's index mod degree+1 along every dim,
    in C order (the order of the JAX package's ``_parity_color_masks``).
    Two nodes share an element only if their indices differ by less than
    degree+1 in every dim, so the nodes of one class are independent."""
    return tuple(itertools.product(range(grid.degree + 1), repeat=grid.ndim))


def color_slices(grid: Grid, color) -> Tuple[slice, ...]:
    """The strided node slices of one colour class (its sub-lattice)."""
    return tuple(slice(c, None, grid.degree + 1) for c in color)


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """Static per-level data."""

    grid: Grid
    dirichlet_mask: torch.Tensor        # nodes + (N,) bool, on the device
    colors: Tuple[Tuple[int, ...], ...]  # GS colour classes (parity_colors)


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Static multigrid configuration built once per (grid, BCs)."""

    levels: Tuple[MGLevel, ...]
    K0: np.ndarray                      # fine-level full-density Ke (f64)
    c_stacks: dict                      # {l: ((2^l)^N, d, d)} deep K0 stacks
    diag_stacks: dict                   # {l: ((2^l)^N, npe, N, N)} their diag blocks
    lmax_bounds: dict                   # {l: bound on lambda_max(D^-1 K)}
    # levels whose Galerkin Ke would exceed this many (fp32) bytes are
    # "transfer" levels, applied as R K_finer P
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


@timers.span("setup.mg_config")
def build_mg_config(prob: FEMProblem, num_levels: int,
                    ke_cache_limit_bytes: int = 1400 * 2**20) -> MGConfig:
    """Build the static hierarchy for `num_levels` coarsenings."""
    if prob.grid.degree != 1 and num_levels > 0:
        raise NotImplementedError(
            "multigrid coarsening supports degree-1 elements; "
            "use num_levels=0 (block-Jacobi PCG) for higher degrees")
    grid = prob.grid
    mask = prob.dirichlet_mask.cpu().numpy()
    levels = [MGLevel(grid, prob.dirichlet_mask, parity_colors(grid))]
    for _ in range(num_levels):
        grid = grid.coarsened()
        mask = coarsen_dirichlet_mask(mask)
        levels.append(MGLevel(grid, torch.as_tensor(mask, device=prob.device),
                              parity_colors(grid)))
    ndim = prob.grid.ndim
    npe = 1 << ndim
    K0 = prob.K0.cpu().numpy()
    c_stacks = {l: deep_coarsened_k0s(K0, ndim, l)
                for l in range(1, num_levels + 1)}
    diag_stacks = {}
    for l, C in c_stacks.items():
        Cr = C.reshape(-1, npe, ndim, npe, ndim)
        diag_stacks[l] = np.stack([Cr[:, a, :, a, :] for a in range(npe)], axis=1)
    lmax_bounds = {0: _pencil_lmax_bound(K0, ndim)}
    for l in range(1, num_levels + 1):
        lmax_bounds[l] = _pencil_lmax_bound(c_stacks[l], ndim)
    return MGConfig(
        levels=tuple(levels),
        K0=K0,
        c_stacks=c_stacks,
        diag_stacks=diag_stacks,
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


def build_level_stiffness(cfg: MGConfig, young: torch.Tensor) -> List[torch.Tensor]:
    """Per-element stiffness matrices ``Ke[l]`` of levels 1..L, shapes
    (dims_l..., d, d), from the fine Young field (reference:
    updateElementStiffnessMatrices + buildPESCoarse)."""
    return [build_level_ke(cfg, young, l) for l in range(1, cfg.num_levels)]


def build_level_ke_diag(cfg: MGConfig, young: torch.Tensor, level: int) -> torch.Tensor:
    """Only the per-element (local-node) diagonal blocks of the level-l
    Ke, (dims_l..., npe, N, N): the smoother diagonals of a level whose
    full Ke is not materialized."""
    D = torch.as_tensor(cfg.diag_stacks[level], dtype=young.dtype,
                        device=young.device)                   # (R, npe, N, N)
    pooled = pooled_young(young, level)                        # (dims_l..., R)
    out = pooled.reshape(-1, D.shape[0]) @ D.reshape(D.shape[0], -1)
    return out.reshape(pooled.shape[:-1] + D.shape[1:])


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
    either is the level's largest array);
    kind "transfer": Ke would exceed ``ke_cache_limit_bytes``, so the
    level applies R K_parent P, exactly the Galerkin operator, through its
    finer ``parent`` level.
    """

    grid: Grid
    dirichlet_mask: torch.Tensor
    colors: Tuple[Tuple[int, ...], ...]  # GS colour classes (parity_colors)
    young: Optional[torch.Tensor]       # level 0 only
    Ke: Optional[torch.Tensor]          # cached levels without a stencil
    Minv_rows: torch.Tensor             # nodes + (N, N) diag blocks of K
    K0: Optional[torch.Tensor]          # level 0 only, in young's dtype
    Dinv: Optional[torch.Tensor] = None  # Chebyshev (and Jacobi) only
    lmax: Optional[float] = None         # Chebyshev only
    kind: str = "cached"
    stencil: Optional[torch.Tensor] = None
    parent: Optional["LevelState"] = None  # transfer levels only
    # level 0 with kernels: the apply of young's dtype and the float64
    # residual's apply that the ``fine_kernel`` setting names
    # (kernels.fine_kernels)
    fine_apply: Optional[Callable] = None
    fine_apply64: Optional[Callable] = None


def _apply_k_level(lv: LevelState, u: torch.Tensor) -> torch.Tensor:
    if lv.kind == "fine":
        if lv.fine_apply is not None:
            return lv.fine_apply(u, lv.young, lv.K0, lv.grid)
        return ops.apply_k(u, lv.young, lv.K0, lv.grid)
    if lv.kind == "transfer":
        ndim = lv.grid.ndim
        return restrict(_apply_k_level(lv.parent, prolongate(u, ndim)), ndim)
    if lv.stencil is not None:
        return kernels.apply_k_cached(u, lv.stencil, lv.grid)
    return ops.apply_k_cached(u, lv.Ke, lv.grid)


def _zero_dirichlet(lv: LevelState, u: torch.Tensor) -> torch.Tensor:
    return u.masked_fill(lv.dirichlet_mask, 0.0)


@timers.span("mg.hierarchy_build")
def build_level_states(
    cfg: MGConfig, prob: FEMProblem, young: torch.Tensor,
    smoother: str = "chebyshev", use_kernels: bool = False,
    fine_kernel: str = "flat32", power_iters: int = 0,
    cached_ke_dtype: Optional[str] = None,
) -> List[LevelState]:
    """The hierarchy's operators for one modulus field (``Dinv`` and
    ``lmax`` only for the Chebyshev smoother).

    ``use_kernels`` routes the fine level (through the kernel of young's
    dtype that ``fine_kernel`` names) and every non-coarsest cached level
    (through the stencil kernels of the level's storage type) through the
    CUDA kernel wrappers, which run their plain twins on CPU tensors. They
    take degree-1 grids: on another degree ``use_kernels`` raises.

    ``cached_ke_dtype="bfloat16"`` stores the intermediate cached levels
    of an fp32 hierarchy in bf16: their node stencil with kernels on,
    their Ke stack without (cast as the JAX package casts it). Their
    diagonal blocks, the next level's Galerkin product and the coarsest
    level stay fp32. ``power_iters`` > 0 takes lambda_max as the smaller
    of the pencil bound and (1.2 / 1.05) x a power estimate of that many
    iterations (:func:`_estimate_lmax`), read to a Python float once here."""
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother={smoother!r}: one of {SMOOTHERS}")
    if cached_ke_dtype not in CACHED_KE_DTYPES:
        raise ValueError(f"cached_ke_dtype={cached_ke_dtype!r}: one of "
                         f"{list(CACHED_KE_DTYPES)}")
    stats["hierarchy_builds"] += 1
    apply32, apply64 = kernels.fine_kernels(fine_kernel)
    degree = cfg.levels[0].grid.degree
    if use_kernels and degree != 1:
        raise ValueError(f"use_kernels on degree-{degree} elements: the CUDA "
                         "kernels take degree-1 grids (use_kernels='auto' takes "
                         "the plain applies there)")
    f64 = young.dtype == torch.float64
    low = CACHED_KE_DTYPES[cached_ke_dtype] if young.dtype == torch.float32 else None
    fine_apply = apply64 if f64 else apply32
    assemble = (kernels.cached_stencil_f64 if f64 else kernels.cached_stencil_bf16
                if low == torch.bfloat16 else kernels.cached_stencil)
    states = []
    last = cfg.num_levels - 1
    prev_ke = None
    for l, lev in enumerate(cfg.levels):
        kind = cfg.level_kind(l)
        Ke = stencil = None
        if l == 0:
            M = ops.node_diag_blocks(young, prob.K0, lev.grid)
        elif kind == "cached":
            if prev_ke is not None and l >= 2:
                # recursive Galerkin from the finer cached level
                Ke = coarsen_ke(prev_ke, lev.grid.ndim)
            else:
                Ke = build_level_ke(cfg, young, l)
            M = ops.node_diag_blocks_cached(Ke, lev.grid)
            # prev_ke keeps the fp32 stack for the next level's coarsen_ke
            prev_ke = Ke
            if use_kernels and l != last:
                stencil = assemble(Ke.contiguous(), lev.grid)
                Ke = None
            elif low is not None and l != last:
                Ke = Ke.to(low)
        else:  # transfer
            M = ops.node_diag_blocks_from_elem_diag(
                build_level_ke_diag(cfg, young, l), lev.grid)
            prev_ke = None  # the recursion needs the immediately finer stack
        states.append(
            LevelState(
                grid=lev.grid,
                dirichlet_mask=lev.dirichlet_mask,
                colors=lev.colors,
                young=young if l == 0 else None,
                Ke=Ke,
                Minv_rows=M,
                K0=prob.K0.to(young.dtype) if l == 0 else None,
                kind=kind,
                stencil=stencil,
                parent=states[-1] if kind == "transfer" else None,
                fine_apply=fine_apply if use_kernels and l == 0 else None,
                fine_apply64=apply64 if use_kernels and l == 0 else None,
            )
        )
    if smoother == "chebyshev":
        for l, lv in enumerate(states):
            lv.Dinv = ops.invert_blocks(lv.Minv_rows)
            bound = cfg.lmax_bounds[l]
            if power_iters <= 0:
                lv.lmax = bound
                continue
            est = timers.read((1.2 / 1.05) * _estimate_lmax(lv, power_iters))
            lv.lmax = min(bound, est)
    return states


def _estimate_lmax(lv: LevelState, iters: int) -> torch.Tensor:
    """Power-iteration estimate of lambda_max(D^-1 K) on the free DOFs,
    times a 1.05 safety factor (the JAX package's ``_estimate_lmax``). The
    start vector is normal noise from a generator seeded with 7 on the
    level's device; the JAX package seeds ``jax.random.PRNGKey(7)``, whose
    numbers differ, so the iterates do and the converged estimate
    agrees."""
    M = lv.Minv_rows
    gen = torch.Generator(device=M.device).manual_seed(7)
    v = _zero_dirichlet(lv, torch.randn(lv.grid.nodes_per_dim + (lv.grid.ndim,),
                                        generator=gen, dtype=M.dtype, device=M.device))
    lam = torch.ones((), dtype=M.dtype, device=M.device)
    for _ in range(iters):
        w = _dinv_apply(lv, _zero_dirichlet(lv, _apply_k_level(lv, v)))
        ww = torch.dot(w.reshape(-1), w.reshape(-1))
        lam = torch.sqrt(ww / torch.clamp(torch.dot(v.reshape(-1), v.reshape(-1)),
                                          min=1e-30))
        v = w / torch.clamp(torch.sqrt(ww), min=1e-30)
    return 1.05 * lam


def _dinv_apply(lv: LevelState, r: torch.Tensor) -> torch.Tensor:
    z = (lv.Dinv * r.unsqueeze(-2)).sum(-1)
    return _zero_dirichlet(lv, z)


def chebyshev_core(apply_fn, dinv_fn, zero_fn, lmax, x, b, degree: int,
                   lower_frac: float = 0.25, x_is_zero: bool = False,
                   need_r: bool = False, r0=None):
    """Degree-`degree` Chebyshev smoothing on D^-1 K over
    [lower_frac*lmax, lmax]. Returns ``(x, r)``; ``r = b - K x`` comes
    free when ``need_r`` (else ``None``), and ``x_is_zero`` skips the
    initial apply, as does ``r0``, a precomputed ``zero_fn(b - K x)``
    (the sharded solver chains its sweeps so)."""
    # scalar coefficients in the working dtype, as the JAX package
    # evaluates them (its lmax is an array of the level's dtype)
    st = np.float32 if b.dtype == torch.float32 else np.float64
    lmax = st(lmax)
    lmin = st(lower_frac) * lmax
    theta = st(0.5) * (lmax + lmin)
    delta = st(0.5) * (lmax - lmin)
    sigma1 = theta / delta

    if r0 is not None:
        r = r0
    else:
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
# Multicolor Gauss-Seidel
# ---------------------------------------------------------------------------

def _gs_trisolve_color(lv: LevelState, r: torch.Tensor, color,
                       forward: bool) -> torch.Tensor:
    """The update of one colour, on its sub-lattice
    (:func:`color_slices`): per node the in-node triangular solve with the
    N x N diagonal block M of K, forward (L + D) or backward (D + U),
    Dirichlet-fixed components left at 0 (the JAX package's
    ``_gs_trisolve_color``, computed on the colour's nodes only)."""
    sl = color_slices(lv.grid, color)
    M = lv.Minv_rows[sl]
    rc = r[sl]
    fixed = lv.dirichlet_mask[sl]
    N = lv.grid.ndim
    ud = [None] * N
    for i in (range(N) if forward else range(N - 1, -1, -1)):
        acc = rc[..., i]
        for j in range(N):
            if ud[j] is not None:
                acc = acc - M[..., i, j] * ud[j]
        ud[i] = (acc / M[..., i, i]).masked_fill(fixed[..., i], 0.0)
    return torch.stack(ud, -1)


def _sub_count(n: int, start: int) -> int:
    """Nodes (or elements) start, start + 2, ... below n."""
    return len(range(start, n, 2))


def apply_k_parity(lv: LevelState, du_p: torch.Tensor, parity) -> torch.Tensor:
    """K du for a degree-1 ``du`` supported on ONE parity class, given as
    its values ``du_p`` on that class's sub-lattice (:func:`color_slices`);
    returns the full node field.

    Fine level and cached levels holding a Ke stack (the JAX package's
    form): every element has exactly one local node of the class, so per
    element parity q the contraction is the N columns of that node (of
    young * K0 or of the element's Ke) against one gathered node value.
    Elements of one parity share no node, so their forces tile the node
    box they cover and land in one add per q. Cached levels holding only
    their node stencil read it directly: output parity q takes the
    offsets o with q + o = parity (mod 2), 3^N slot reads in all."""
    if lv.stencil is not None:
        return _apply_k_parity_stencil(lv, du_p, parity)
    grid = lv.grid
    N = grid.ndim
    npe = grid.nodes_per_elem
    dims = grid.dims
    out = du_p.new_zeros(grid.nodes_per_dim + (N,))
    if lv.kind == "fine":
        K0r = lv.K0.to(du_p.dtype).reshape(npe, N, npe, N)
    for q in itertools.product((0, 1), repeat=N):
        nq = tuple(_sub_count(dims[d], q[d]) for d in range(N))
        if 0 in nq:
            continue
        # the class's node in these elements: local offset o, local index
        # a_star (C order), at sub-lattice index k + s_in of element q + 2k
        o = [(parity[d] - q[d]) % 2 for d in range(N)]
        a_star = sum(o[d] << (N - 1 - d) for d in range(N))
        s_in = [(q[d] + o[d] - parity[d]) // 2 for d in range(N)]
        dc = du_p[tuple(slice(s_in[d], s_in[d] + nq[d]) for d in range(N))]
        esl = tuple(slice(qd, None, 2) for qd in q)
        if lv.kind == "fine":
            block = K0r[:, :, a_star, :].reshape(npe * N, N)
            fe = (dc.reshape(-1, N) @ block.t()).reshape(nq + (npe, N))
            fe = lv.young[esl][..., None, None] * fe
        else:
            Keq = lv.Ke[esl].reshape(nq + (npe, N, npe, N))[..., a_star, :]
            fe = (Keq.to(du_p.dtype) @ dc[..., None, :, None]).squeeze(-1)
        # local node a of element q + 2k is node q + 2k + offset(a): view the
        # node box [q, q + 2 nq) as (nq_0, 2, nq_1, 2, ...) and add once
        box = out[tuple(slice(q[d], q[d] + 2 * nq[d]) for d in range(N))]
        for d in range(N):
            box = box.unflatten(2 * d, (nq[d], 2))
        fe = fe.reshape(nq + (2,) * N + (N,))
        box += fe.permute([x for d in range(N) for x in (d, N + d)] + [2 * N])
    return out


def _apply_k_parity_stencil(lv: LevelState, du_p: torch.Tensor,
                            parity) -> torch.Tensor:
    S = lv.stencil
    grid = lv.grid
    N = grid.ndim
    nodes = grid.nodes_per_dim
    slots = kernels.stencil_offsets(N)
    out = du_p.new_zeros(nodes + (N,))
    # one zero node on every side: slots whose neighbour is off the grid
    # read zeros
    dpad = torch.nn.functional.pad(du_p, (0, 0) + (1, 1) * N)
    for q in itertools.product((0, 1), repeat=N):
        nq = tuple(_sub_count(nodes[d], q[d]) for d in range(N))
        if 0 in nq:
            continue
        offs = list(itertools.product(*[(0,) if q[d] == parity[d] else (-1, 1)
                                        for d in range(N)]))
        sub = tuple(slice(qd, None, 2) for qd in q)
        Sq = torch.stack([S[(slots.index(o), slice(None), slice(None)) + sub]
                          for o in offs]).to(du_p.dtype)  # (k, N, N, nq...)
        # node q + 2m + o is index m + (q + o - parity) // 2 of the class
        win = torch.stack([
            dpad[tuple(slice(1 + (q[d] + o[d] - parity[d]) // 2,
                             1 + (q[d] + o[d] - parity[d]) // 2 + nq[d])
                       for d in range(N))]
            for o in offs])                               # (k, nq..., N)
        f = (Sq * win.movedim(-1, 1).unsqueeze(1)).sum((0, 2))
        out[sub] = f.movedim(0, -1)
    return out


def gs_sweep(lv: LevelState, u: torch.Tensor, b: torch.Tensor,
             forward: bool = True) -> torch.Tensor:
    """One multicolor Gauss-Seidel sweep over the level's colour classes
    (reverse order when not ``forward``).

    The residual r = b - K u is computed once, with the level's full
    apply, then carried across colours: r <- r - K du with du on the
    just-updated class, from :func:`apply_k_parity`. Transfer levels and
    grids of another degree have no parity apply and take the full apply
    per colour, as in the JAX package."""
    colors = lv.colors if forward else lv.colors[::-1]
    parity_ok = lv.kind != "transfer" and lv.grid.degree == 1
    r = b - _apply_k_level(lv, u)
    u = u.clone()
    for k, c in enumerate(colors):
        sl = color_slices(lv.grid, c)
        du = _gs_trisolve_color(lv, r, c, forward)
        u[sl] += du
        if k == len(colors) - 1:
            break
        if parity_ok:
            r -= apply_k_parity(lv, du, c)
        else:
            full = torch.zeros_like(u)
            full[sl] = du
            r -= _apply_k_level(lv, full)
    return u


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
    K = ops.pin_dirichlet(solvers.assemble_dense_k_traced(lv.Ke, lv.grid),
                          lv.dirichlet_mask)
    # relative diagonal shift, decisively above the fp32 Galerkin
    # rounding floor (see ndr_tpu.fem.multigrid._coarsest_dense_k): the
    # coarse solve only preconditions, and an indefinite fp32 coarse K
    # would NaN the Cholesky
    eps = 1e-4 if K.dtype == torch.float32 else 1e-12
    diag = K.diagonal()
    diag.add_(eps * diag)
    return K


@timers.span("mg.coarsest_factor")
def factor_coarsest(levels: List[LevelState], method: str = "cholesky"):
    """("chol", L) with the lower Cholesky factor, or ("ns", X) with a
    Jacobi-scaled Newton–Schulz inverse."""
    K = _coarsest_dense_k(levels)
    if method == "cholesky":
        L = torch.linalg.cholesky(K)
        timers.count("host_reads")   # the factorization reads its error code back
        return ("chol", L)
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

def _smooth(lv: LevelState, x, b, nsmooth: int, forward: bool, smoother: str,
            cheb_degree: int, x_is_zero: bool = False, need_r: bool = False):
    """Returns ``(x, r)``; ``r`` is ``b - K x`` when the smoother yields
    it for free (Chebyshev with ``need_r``), else ``None``."""
    if smoother == "chebyshev":
        # degree plays the role of "sweeps"; direction is irrelevant
        return chebyshev_smooth(lv, x, b, degree=cheb_degree * nsmooth,
                                x_is_zero=x_is_zero, need_r=need_r)
    for _ in range(nsmooth):
        x = gs_sweep(lv, x, b, forward=forward)
    return x, None


def vcycle(levels, chol, l, x, b, nsmooth: int, symmetric_gs: bool = True,
           smoother: str = "gs", cheb_degree: int = 2, x_zero: bool = False):
    """One V-cycle from level ``l``: the pre-smoother sweeps forward, the
    post-smoother backward when ``symmetric_gs`` (GS only)."""
    if l == len(levels) - 1:
        return _coarse_solve(levels[l], chol, b)
    lv = levels[l]
    x = x if x_zero else _zero_dirichlet(lv, x)
    x, r = _smooth(lv, x, b, nsmooth, True, smoother, cheb_degree,
                   x_is_zero=x_zero, need_r=True)
    if r is None:  # GS: explicit residual
        r = _zero_dirichlet(lv, b - _apply_k_level(lv, x))
    b_c = restrict(r, lv.grid.ndim)
    x_c = vcycle(levels, chol, l + 1, torch.zeros_like(b_c), b_c, nsmooth,
                 symmetric_gs, smoother, cheb_degree, x_zero=True)
    x = x + prolongate(x_c, lv.grid.ndim)
    x, _ = _smooth(lv, x, b, nsmooth, not symmetric_gs, smoother, cheb_degree)
    return x


def full_multigrid(levels, chol, l, b, nsmooth: int, symmetric_gs: bool = True,
                   smoother: str = "gs", cheb_degree: int = 2):
    if l == len(levels) - 1:
        return _coarse_solve(levels[l], chol, b)
    b_c = restrict(b, levels[l].grid.ndim)
    x_c = full_multigrid(levels, chol, l + 1, b_c, nsmooth, symmetric_gs,
                         smoother, cheb_degree)
    x = prolongate(x_c, levels[l].grid.ndim)
    return vcycle(levels, chol, l, x, b, nsmooth, symmetric_gs, smoother,
                  cheb_degree)


def mg_preconditioner(levels, chol, r, mg_iterations: int, nsmooth: int,
                      fmg: bool, smoother: str = "gs", cheb_degree: int = 2):
    """s ~= K^-1 r (symmetric GS cycles, as in the JAX package)."""
    if fmg:
        s = full_multigrid(levels, chol, 0, r, nsmooth, True, smoother, cheb_degree)
        for _ in range(mg_iterations - 1):
            s = vcycle(levels, chol, 0, s, r, nsmooth, True, smoother, cheb_degree)
    else:
        s = torch.zeros_like(r)
        for k in range(mg_iterations):
            s = vcycle(levels, chol, 0, s, r, nsmooth, True, smoother,
                       cheb_degree, x_zero=(k == 0))
    return s


# ---------------------------------------------------------------------------
# MGPCG driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MGSolverSettings:
    """Solver knobs, with ``ndr_tpu.fem.multigrid.MGSolverSettings``'s
    defaults (``smoother``: "gs", the multicolor Gauss-Seidel sweep, or
    "chebyshev"; ``ground_truth_topopt`` passes "chebyshev"). The JAX package's
    ``symmetric_gs`` field is read by nothing there (its preconditioner
    always runs symmetric cycles), so it has no counterpart here."""

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
    # storage type of the intermediate cached levels of fp32 hierarchies:
    # None (fp32) or "bfloat16" (half the bytes; the JAX package notes that
    # it hurts the preconditioner: the rounding perturbs the coarse
    # elements' rigid-body null space)
    cached_ke_dtype: Optional[str] = None
    # power-iteration budget of the Chebyshev lambda_max estimate (min'ed
    # with the pencil bound); 0 = the bound alone
    lmax_power_iters: int = 0
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
    # under a lagged preconditioner, rebuild level 0's density-dependent
    # smoother state (young, Minv_rows, Dinv) from the current density
    # every solve; the coarser levels and the coarsest factor keep their
    # lagged values
    precond_refresh_fine: bool = True


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


def resolve_use_kernels(setting, device: torch.device, grid: Grid) -> bool:
    """``"auto"`` means on for CUDA tensors of a degree-1 grid (the
    kernels' grids; the JAX package takes XLA on other degrees);
    True/False are explicit."""
    if setting == "auto":
        return torch.device(device).type == "cuda" and grid.degree == 1
    return bool(setting)


def describe_applies(prob: FEMProblem, settings: MGSolverSettings) -> str:
    """Which stiffness applies a solve with ``settings`` runs on ``prob``,
    for the run's log."""
    if resolve_use_kernels(settings.use_kernels, prob.device, prob.grid):
        if prob.device.type == "cuda":
            return f"CUDA kernels (fine_kernel={settings.fine_kernel})"
        return "the kernel wrappers' plain twins (CPU tensors)"
    why = (f"degree-{prob.grid.degree} grid: the kernels take degree 1"
           if prob.grid.degree != 1 and settings.use_kernels == "auto"
           else f"use_kernels={settings.use_kernels!r} on {prob.device.type}")
    return f"plain torch ops ({why})"


def _use_refined(prob: FEMProblem, settings: MGSolverSettings) -> bool:
    return settings.mixed_precision and prob.force.dtype == torch.float32


def _build_hierarchy(cfg: MGConfig, prob: FEMProblem, young: torch.Tensor,
                     settings: MGSolverSettings):
    """(levels, coarse): the level operators for ``young`` and the coarsest
    factor (None for the block-Jacobi preconditioner)."""
    levels = build_level_states(
        cfg, prob, young, smoother=settings.smoother,
        use_kernels=resolve_use_kernels(settings.use_kernels, prob.device, prob.grid),
        fine_kernel=settings.fine_kernel, power_iters=settings.lmax_power_iters,
        cached_ke_dtype=settings.cached_ke_dtype)
    if settings.precond == "jacobi":
        if levels[0].Dinv is None:  # a GS hierarchy builds no Dinv
            levels[0].Dinv = ops.invert_blocks(levels[0].Minv_rows)
        return levels, None
    return levels, factor_coarsest(levels, _resolve_coarse_solver(settings, levels))


class PrecondGraph:
    """One preconditioner call ``z = fn(r)`` captured as a CUDA graph.

    ``fn`` runs once eagerly on a side stream first (lazy set-up, and the
    fine kernels' K0 upload, which a capture refuses), then once under
    capture into the static input ``r`` and output ``z``. A call copies its
    argument into ``r``, replays the graph and returns a copy of ``z``, so
    the next replay cannot overwrite what the caller holds. Kernel launch
    counts (:data:`kernels.launches`) take the capture's records back out
    and add them again at every replay. A capture or replay that fails
    raises: there is no eager fallback."""

    def __init__(self, fn, example: torch.Tensor, lv0: LevelState,
                 warmup: bool = True):
        self.key = (tuple(example.shape), example.dtype)
        self.lv0 = lv0
        self.r = example.clone()
        self._upload()
        dev = example.device
        if warmup:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(self.r)
            torch.cuda.current_stream(dev).wait_stream(side)
        with timers.span("mg.graph_capture"):
            before = dict(kernels.launches)
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    self.z = fn(self.r)
            finally:
                self.counts = {k: kernels.launches[k] - n for k, n in before.items()}
                kernels.add_launches(self.counts, -1)   # recorded, not launched
            torch.cuda.synchronize(dev)
        stats["graph_captures"] += 1
        stats["graph_capture_seconds"] = stats["mg.graph_capture.s"]

    def _upload(self) -> None:
        # the fine kernels' constant memory is not the graph's: make it hold
        # this hierarchy's K0 (a no-op unless another K0 was uploaded since)
        if self.lv0.fine_apply is not None:
            kernels.upload_fine_blocks(self.lv0.K0, self.lv0.grid)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        self._upload()
        self.r.copy_(r)
        self.graph.replay()
        kernels.add_launches(self.counts)
        stats["graph_replays"] += 1
        return self.z.clone()


@dataclasses.dataclass
class PrecondState:
    """A lagged preconditioner (the JAX package's precond leaves): the
    level operators built at one density and the coarsest factor (None
    for the block-Jacobi preconditioner). With ``use_graph`` its
    preconditioner calls on CUDA are replayed from one
    :class:`PrecondGraph`, captured at the first call and kept while
    rebuilds write into the same tensors (``build_precond(..., into=)``);
    a rebuild that changes a level's lambda_max drops it (the Chebyshev
    coefficients are constants of the graph)."""

    levels: List[LevelState]
    coarse: Optional[Tuple[str, torch.Tensor]]
    use_graph: bool = False
    graph: Optional[PrecondGraph] = None

    def graphed(self, fn):
        """``fn`` (this state's preconditioner) replayed from its graph."""
        def call(r):
            if self.graph is None or self.graph.key != (tuple(r.shape), r.dtype):
                self.graph = PrecondGraph(fn, r, self.levels[0])
            return self.graph(r)
        return call


_STATE_FIELDS = ("young", "Ke", "Minv_rows", "Dinv", "stencil")


@timers.span("mg.precond_build")
def build_precond(cfg: MGConfig, prob: FEMProblem, rho: torch.Tensor,
                  settings: MGSolverSettings, into: Optional[PrecondState] = None,
                  use_graph: bool = False) -> PrecondState:
    """The hierarchy and coarsest factor for ``rho``, as a
    :class:`PrecondState` for ``mgpcg_solve(..., precond_state=)`` (the JAX
    package's ``build_precond_leaves``). With ``into`` the new operators are
    copied into that state's tensors, which keeps its CUDA graph valid;
    ``use_graph`` turns graph replay on for a new state."""
    young = prob.young(rho)
    if _use_refined(prob, settings):
        young = young.to(torch.float32)
    levels, coarse = _build_hierarchy(cfg, prob, young, settings)
    if into is None:
        return PrecondState(levels, coarse, use_graph=use_graph)
    for dst, src in zip(into.levels, levels):
        for f in _STATE_FIELDS:
            a, b = getattr(dst, f), getattr(src, f)
            if (a is None) != (b is None):
                raise ValueError(f"precond state: {f} differs in kind from the rebuild")
            if a is not None:
                a.copy_(b)
        if dst.lmax != src.lmax:
            dst.lmax = src.lmax
            into.graph = None
    if coarse is not None:
        into.coarse[1].copy_(coarse[1])
    return into


def _refresh_fine_level(prob: FEMProblem, lv0: LevelState, young: torch.Tensor) -> None:
    """Rebuild level 0's density-dependent smoother state (young,
    Minv_rows, Dinv; the GS colour solve reads Minv_rows) from the current
    density, in place (the JAX package's ``_refresh_fine_level``). Writing
    into the level's own tensors keeps every transfer level's parent link
    on the refreshed level, and a captured graph valid."""
    M0 = ops.node_diag_blocks(young, prob.K0, lv0.grid)
    lv0.young.copy_(young)
    lv0.Minv_rows.copy_(M0)
    if lv0.Dinv is not None:
        lv0.Dinv.copy_(ops.invert_blocks(M0))


def _solve_levels(cfg, prob, young, settings, state: Optional[PrecondState]):
    """(levels, coarse, lv0_op) of one solve: the preconditioner's levels
    and coarsest factor, built for ``young`` or the lagged ``state``'s; and
    the level-0 operator of the CG, always at ``young``."""
    if state is None:
        levels, coarse = _build_hierarchy(cfg, prob, young, settings)
        return levels, coarse, levels[0]
    levels = state.levels
    if settings.precond_refresh_fine:
        _refresh_fine_level(prob, levels[0], young)
        return levels, state.coarse, levels[0]
    return levels, state.coarse, dataclasses.replace(levels[0], young=young)


def _make_preconditioner(settings, levels, coarse, state=None):
    lv0 = levels[0]
    if settings.precond == "jacobi":
        def precond(r):
            return _dinv_apply(lv0, r)
        return precond

    def precond(r):
        s = mg_preconditioner(
            levels, coarse, r, settings.mg_iterations,
            settings.mg_smoothing_iterations, settings.full_multigrid,
            settings.smoother, settings.cheb_degree,
        )
        return _zero_dirichlet(lv0, s)
    if state is not None and state.use_graph and lv0.Minv_rows.is_cuda:
        return state.graphed(precond)
    return precond


def mgpcg_solve(
    cfg: MGConfig,
    prob: FEMProblem,
    rho: torch.Tensor,
    u0: Optional[torch.Tensor],
    settings: MGSolverSettings,
    precond_state: Optional[PrecondState] = None,
) -> Tuple[torch.Tensor, int]:
    """Full MGPCG equilibrium solve K(rho) u = f: rebuild the Galerkin
    hierarchy for ``rho`` (or precondition with the lagged
    ``precond_state``, whose level 0 is refreshed to ``rho`` under
    ``settings.precond_refresh_fine``), factor the coarsest level, run PCG
    from the warm start. The CG operator always uses ``rho``. Float32
    problems with ``settings.mixed_precision`` run as float64 iterative
    refinement around the fp32 MGPCG."""
    if _use_refined(prob, settings):
        return _mgpcg_solve_refined(cfg, prob, rho, u0, settings, precond_state)
    young = prob.young(rho)
    levels, coarse, lv0 = _solve_levels(cfg, prob, young, settings, precond_state)

    def apply_a(u):
        return _zero_dirichlet(lv0, _apply_k_level(lv0, _zero_dirichlet(lv0, u)))

    precond = _make_preconditioner(settings, levels, coarse, precond_state)
    b = _zero_dirichlet(lv0, prob.force)
    if u0 is None or settings.zero_init:
        u0 = torch.zeros_like(b)
    u0 = _zero_dirichlet(lv0, u0.to(b.dtype))
    with timers.span("mg.cg"):
        u, iters = solvers.conjugate_gradient(
            apply_a, b, u0, tol=settings.tol, max_iter=settings.cg_iter,
            precond=precond)
    _count_pass(iters, settings)
    return u, iters


def _count_pass(iters: int, settings: MGSolverSettings) -> None:
    """Count one CG pass's iterations, and the pass if it stopped at the cap."""
    stats["cg_iters"] += iters
    stats["cg_passes_at_cap"] += iters >= settings.cg_iter


def _mgpcg_solve_refined(
    cfg: MGConfig,
    prob: FEMProblem,
    rho: torch.Tensor,
    u0: Optional[torch.Tensor],
    settings: MGSolverSettings,
    precond_state: Optional[PrecondState] = None,
) -> Tuple[torch.Tensor, int]:
    """Float64 iterative refinement around the fp32 MGPCG.

    Outer loop (float64): r = b - K u with the exact float64 operator at
    the current ``rho``; stop when ||r|| <= tol * ||b||. Inner loop: fp32
    MGPCG on the correction system, targeting the final tolerance
    directly, with a second pass only when the needed reduction exceeds
    what one fp32 solve can deliver (cold starts). With kernels on, the
    float64 residual is the float64 fine kernel of ``settings.fine_kernel``
    at every tol.
    """
    f32, f64 = torch.float32, torch.float64
    young32 = prob.young(rho).to(f32)
    levels, coarse, lv0 = _solve_levels(cfg, prob, young32, settings, precond_state)

    K0_64 = prob.K0.to(f64)
    young64 = ops.element_young_modulus(
        rho.to(f64), prob.E0, prob.Emin, prob.gamma)
    force64 = prob.force.to(f64)
    apply64 = lv0.fine_apply64 or ops.apply_k

    @timers.span("mg.residual64")
    def residual64(u):
        return _zero_dirichlet(lv0, force64 - apply64(u, young64, K0_64, lv0.grid))

    def apply_a32(v):
        return _zero_dirichlet(lv0, _apply_k_level(lv0, _zero_dirichlet(lv0, v)))

    precond32 = _make_preconditioner(settings, levels, coarse, precond_state)

    b64 = _zero_dirichlet(lv0, force64)
    b_norm = timers.read(torch.linalg.norm(b64.reshape(-1)))
    if u0 is None or settings.zero_init:
        u = torch.zeros_like(b64)
    else:
        u = _zero_dirichlet(lv0, u0.to(f64))

    fp32_floor = 5e-4  # smallest reduction one fp32 CG pass can deliver
    r = residual64(u)
    done, total_iters, k = False, 0, 0
    while not done and k < settings.max_refinements:
        rn = max(timers.read(torch.linalg.norm(r.reshape(-1))), 1e-300)
        needed = settings.tol * b_norm / rn
        inner_tol = torch.tensor(float(np.clip(0.5 * needed, fp32_floor, 0.9)),
                                 dtype=f32, device=u.device)
        with timers.span("mg.cg"):
            e32, iters = solvers.conjugate_gradient(
                apply_a32, r.to(f32), torch.zeros(r.shape, dtype=f32, device=u.device),
                tol=inner_tol, max_iter=settings.cg_iter, precond=precond32,
            )
        u = u + e32.to(f64)
        _count_pass(iters, settings)
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
    """Returns a SolveFn (rho, u0=None, precond=None) -> (u, iters)
    closure for topopt; ``solve.build_precond(rho, into=None,
    use_graph=False)`` builds the lagged ``precond`` (:func:`build_precond`).

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

    @timers.span("solve")
    def solve(rho, u0=None, precond=None):
        return mgpcg_solve(cfg, prob, rho, u0, settings, precond_state=precond)

    def build(rho, into=None, use_graph=False):
        return build_precond(cfg, prob, rho, settings, into=into, use_graph=use_graph)

    solve.cfg = cfg
    solve.settings = settings
    solve.build_precond = build
    return solve
