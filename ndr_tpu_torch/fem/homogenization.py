"""Periodic homogenization of voxel microstructures (counterpart of
``ndr_tpu/fem/homogenization.py``).

  * Periodicity is structural: DoF fields live on the grid without its
    max-face node planes, and the stiffness apply wrap-expands them onto
    the full node grid and folds the forces back (P^T K P, P the periodic
    prolongation).
  * Rigid translation is removed by pinning node 0.
  * The 3 (2-D) / 6 (3-D) cell problems solve together in one batched
    block-Jacobi CG (:func:`solvers.conjugate_gradient_batched`): one host
    read per iteration for all of them.
  * The homogenized tensor, its per-voxel density gradient and the
    closest-isotropic projection are contractions over elements.

On a card, with a degree-1 grid, :func:`periodic_apply_k` applies K to each
expanded field through the hand-written fine kernel of the field's dtype
(``kernels.fine_kernels(fine_kernel)``: ``apply_k_fine_f64`` for float64
cells, ``apply_k_fine_f32`` for fp32), one launch per field; the expanded
field has exactly the node shape those kernels take. ``use_kernels`` has
the solver's convention: "auto" is the kernels on CUDA tensors of a
degree-1 grid and the plain apply elsewhere, True on another degree
raises, and a kernel that fails raises (there is no fallback).

Density convention: one ``modulus`` field scales both the constant-strain
loads and K (the reference's convention for gamma=1, Emin=0).

Voigt order (xx, yy[, zz, yz, xz], xy), engineering convention: the D
returned satisfies sigma_v = D eps_v with shear strains doubled. Eh and
its density gradient come from the symmetric energy identity
e^s : C_h : e^t = (1/|Y|) int (e^s + eps(w^s)) : C : (e^t + eps(w^t)).
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import element as el
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.multigrid import resolve_use_kernels
from ndr_tpu_torch.grid import Grid


def voigt_strains(ndim: int) -> np.ndarray:
    """Canonical unit strains in MeshFEM flat order, (S, N, N)."""
    out = [np.zeros((ndim, ndim)) for _ in range(ndim)]
    for i in range(ndim):
        out[i][i, i] = 1.0
    shear_pairs = {2: [(0, 1)], 3: [(1, 2), (0, 2), (0, 1)]}[ndim]
    for (i, j) in shear_pairs:
        E = np.zeros((ndim, ndim))
        E[i, j] = E[j, i] = 1.0
        out.append(E)
    return np.stack(out)


def num_strains(ndim: int) -> int:
    return ndim * (ndim + 1) // 2


# ---------------------------------------------------------------------------
# Periodic operator. A field's node axes are the ndim axes before its last
# (component) axis, so a batch of fields (S, dims..., N) takes the same calls.
# ---------------------------------------------------------------------------

def periodic_expand(u_dof: torch.Tensor, ndim: int) -> torch.Tensor:
    """DoF field (dims..., N) -> full node field, the first node planes
    wrapped onto the max faces (the periodic prolongation P)."""
    lead = u_dof.shape[:u_dof.dim() - ndim - 1]
    dims = u_dof.shape[-ndim - 1:-1]
    out = u_dof.new_empty(lead + tuple(n + 1 for n in dims) + u_dof.shape[-1:])
    body = (Ellipsis,) + tuple(slice(0, n) for n in dims) + (slice(None),)
    out[body] = u_dof
    for k in range(ndim):
        axis = out.dim() - ndim - 1 + k
        out.select(axis, dims[k]).copy_(out.select(axis, 0))
    return out


def _fold_(f_full: torch.Tensor, ndim: int) -> torch.Tensor:
    """:func:`periodic_fold` adding into ``f_full`` itself; returns a view."""
    f = f_full
    for k in range(ndim):
        axis = f.dim() - ndim - 1 + k
        n = f.shape[axis] - 1
        f.select(axis, 0).add_(f.select(axis, n))
        f = f.narrow(axis, 0, n)
    return f


def periodic_fold(f_full: torch.Tensor, ndim: int) -> torch.Tensor:
    """Full node field -> DoF field, the max-face values accumulated onto
    the min faces (P^T)."""
    return _fold_(f_full.clone(), ndim).contiguous()


def _pin_(u: torch.Tensor, ndim: int) -> torch.Tensor:
    u[(Ellipsis,) + (0,) * ndim + (slice(None),)] = 0.0
    return u


def _pin(u_dof: torch.Tensor, ndim: Optional[int] = None) -> torch.Tensor:
    """Zero the pinned node-0 components (no rigid translation) of a DoF
    field, or with ``ndim`` of every field of a batch (S, dims..., N)."""
    return _pin_(u_dof.clone(), u_dof.dim() - 1 if ndim is None else ndim)


def _use_kernels(use_kernels, t: torch.Tensor, grid: Grid) -> bool:
    if use_kernels is True and grid.degree != 1:
        raise ValueError(f"use_kernels on degree-{grid.degree} elements: the CUDA "
                         "kernels take degree-1 grids (use_kernels='auto' takes the "
                         "plain apply there)")
    return resolve_use_kernels(use_kernels, t.device, grid)


def _apply_k_batched(u: torch.Tensor, modulus: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """Plain K(modulus) u of node fields with any leading batch axes: one
    gather, one product and one scatter for the whole batch."""
    Ue = ops.gather_element_displacements(u, grid)       # (..., dims, npe, N)
    d = Ue.shape[-2] * grid.ndim
    Fe = torch.matmul(Ue.reshape(Ue.shape[:-2] + (d,)), K0.to(u.dtype).t()) \
        * modulus[..., None]
    return ops.scatter_element_forces(Fe.reshape(Ue.shape), grid)


def periodic_apply_k(u_dof: torch.Tensor, modulus: torch.Tensor, K0: torch.Tensor,
                     grid: Grid, use_kernels="auto",
                     fine_kernel: str = "flat32") -> torch.Tensor:
    """f = P^T K(modulus) P u on periodic DoFs (the pin is the caller's), for
    one field (dims..., N) or a batch (S, dims..., N).

    With the kernels (see the module docstring) each field is one launch,
    and ``modulus`` and ``K0`` must have u's dtype and device; pass the same
    K0 tensor to every call, so the kernel uploads its blocks once."""
    N = grid.ndim
    u_full = periodic_expand(u_dof, N)
    if not _use_kernels(use_kernels, u_dof, grid):
        return _fold_(_apply_k_batched(u_full, modulus, K0, grid), N).contiguous()
    f32, f64 = kernels.fine_kernels(fine_kernel)
    apply = f64 if u_dof.dtype == torch.float64 else f32
    if u_dof.dim() == N + 1:
        return _fold_(apply(u_full, modulus, K0, grid), N).contiguous()
    out = torch.empty_like(u_dof)
    for s in range(u_dof.shape[0]):
        out[s] = _fold_(apply(u_full[s], modulus, K0, grid), N)
    return out


# ---------------------------------------------------------------------------
# Cell problems
# ---------------------------------------------------------------------------

def _canonical_to_voigt_perm(ndim: int) -> np.ndarray:
    """Map element.canonical_strains order -> Voigt order."""
    cs = el.canonical_strains(ndim)
    vs = voigt_strains(ndim)
    perm = []
    for v in vs:
        for i, c in enumerate(cs):
            if np.allclose(c, v):
                perm.append(i)
                break
    return np.asarray(perm)


def _voigt_loads(grid: Grid, material: el.IsotropicMaterial) -> np.ndarray:
    """Per-element constant-strain loads in Voigt order, (S, npe, N)."""
    degrees = tuple([grid.degree] * grid.ndim)
    loads = el.constant_strain_load_matrix(degrees, grid.stretchings, material)
    return loads[_canonical_to_voigt_perm(grid.ndim)]


def constant_strain_loads(modulus: torch.Tensor, grid: Grid,
                          material: el.IsotropicMaterial) -> torch.Tensor:
    """Global periodic-DoF loads of each canonical strain, (S, dims..., N):
    rhs^s = P^T scatter(modulus_e * l^s), l^s the per-element
    constant-strain load."""
    out = []
    for le in _voigt_loads(grid, material):
        fe = modulus[..., None, None] * torch.as_tensor(le, dtype=modulus.dtype,
                                                        device=modulus.device)
        out.append(_fold_(ops.scatter_element_forces(fe, grid), grid.ndim))
    return torch.stack(out)


def _as_k0(K0, like: torch.Tensor) -> torch.Tensor:
    """K0 in ``like``'s dtype and device: the same tensor where it already is."""
    return torch.as_tensor(K0, dtype=like.dtype, device=like.device).contiguous()


def _solve_cells(rho: torch.Tensor, grid: Grid, material: el.IsotropicMaterial,
                 K0: torch.Tensor, tol: float, max_iter: int, use_kernels,
                 fine_kernel: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, CG iterations per cell problem) of :func:`solve_cell_problems`;
    ``K0`` already in rho's dtype and device."""
    N = grid.ndim
    modulus = rho
    rhs = _pin_(-constant_strain_loads(modulus, grid, material), N)

    blocks_full = ops.node_diag_blocks(modulus, K0, grid)
    blocks = _fold_(blocks_full.reshape(blocks_full.shape[:-2] + (N * N,)), N)
    inv = ops.invert_blocks(blocks.reshape(blocks.shape[:-1] + (N, N)))

    def apply_a(u):
        return _pin_(periodic_apply_k(_pin(u, N), modulus, K0, grid, use_kernels,
                                      fine_kernel), N)

    def precond(r):
        z = inv[..., :, 0] * r[..., 0:1]
        for j in range(1, N):
            z = z + inv[..., :, j] * r[..., j:j + 1]
        return _pin_(z, N)

    return solvers.conjugate_gradient_batched(
        apply_a, rhs, torch.zeros_like(rhs), tol=tol, max_iter=max_iter,
        precond=precond)


def solve_cell_problems(
    rho: torch.Tensor,
    grid: Grid,
    material: el.IsotropicMaterial,
    K0,
    tol: float = 1e-8,
    max_iter: int = 2000,
    use_kernels="auto",
    fine_kernel: str = "flat32",
) -> torch.Tensor:
    """Solve the S periodic cell problems in one batched block-Jacobi CG;
    returns the fluctuation fields w, (S, dims..., N) on periodic DoFs
    (rhs: the load of the negative canonical strain).

    The preconditioner inverts the periodically folded per-node diagonal
    blocks. K0 is converted once (to rho's dtype and device) and that one
    tensor serves every apply. :func:`homogenize` also returns the CG
    iterations."""
    return _solve_cells(rho, grid, material, _as_k0(K0, rho), tol, max_iter, use_kernels,
                        fine_kernel)[0]


# ---------------------------------------------------------------------------
# Homogenized tensor + gradient
# ---------------------------------------------------------------------------

def average_strain_matrix(grid: Grid, material_dim: int) -> np.ndarray:
    """B-bar: element-average strains of nodal displacements, in Voigt
    order, shape (S, dofs_pe) acting on flattened element DOFs, producing
    tensor strain components (off-diagonals not doubled)."""
    degrees = tuple([grid.degree] * grid.ndim)
    stretch = grid.stretchings
    axes = [el.gauss_rule_for_degree(2 * d) for d in degrees]
    pts = np.array([p for p in itertools.product(*[a[0] for a in axes])])
    wts = np.array([np.prod(w) for w in itertools.product(*[a[1] for a in axes])])
    _, grads = el.shape_gradients_at(degrees, stretch, pts)  # (npe, Q, N)
    N = grid.ndim
    eye = np.eye(N)
    eps = 0.5 * (
        np.einsum("ci,aqj->acqij", eye, grads) + np.einsum("cj,aqi->acqij", eye, grads)
    )  # (npe, N, Q, N, N)
    avg = np.einsum("acqij,q->acij", eps, wts)
    vs = voigt_strains(N)
    B = np.zeros((vs.shape[0], grads.shape[0] * N))
    for s, V in enumerate(vs):
        i, j = np.argwhere(V)[0]
        B[s] = avg[:, :, i, j].reshape(-1)
    return B


def _shear_multiplicity(ndim: int) -> np.ndarray:
    """m_s = 1 for normal entries, 2 for shear entries: D = B / (m_s m_t)."""
    m = np.ones(num_strains(ndim))
    m[ndim:] = 2.0
    return m


def _energy_form_per_element(w: torch.Tensor, grid: Grid, material, K0) -> torch.Tensor:
    """(dims..., S, S): per-element integrals
    int_e (e^s + eps(w^s)) : C : (e^t + eps(w^t))  (not density-scaled)."""
    N = grid.ndim
    S = num_strains(N)
    vs = voigt_strains(N)
    loads = torch.as_tensor(_voigt_loads(grid, material).reshape(S, -1),
                            dtype=w.dtype, device=w.device)          # (S, d)
    K0 = _as_k0(K0, w)
    const = np.einsum("sij,ijkl,tkl->st", vs, material.full_tensor(), vs) \
        * grid.element_volume
    const = torch.as_tensor(const, dtype=w.dtype, device=w.device)
    Ue = ops.gather_element_displacements(periodic_expand(w, N), grid)
    Ue = Ue.reshape(S, -1, Ue.shape[-2] * N)                           # (S, E, d)
    cross = torch.einsum("sd,ted->est", loads, Ue)
    quad = torch.einsum("sed,ted->est", Ue, torch.matmul(Ue, K0.t()))
    out = const + cross + cross.transpose(-1, -2) + quad
    return out.reshape(tuple(grid.dims) + (S, S))


def _multiplicity(ndim: int, like: torch.Tensor) -> torch.Tensor:
    """m_s m_t as a (S, S) tensor of ``like``'s dtype and device."""
    m = torch.as_tensor(_shear_multiplicity(ndim), dtype=like.dtype, device=like.device)
    return m[:, None] * m[None, :]


def _tensor_from_form(per_elem: torch.Tensor, rho: torch.Tensor, grid: Grid) -> torch.Tensor:
    B = torch.einsum("...st,...->st", per_elem, rho) / grid.volume
    return B / _multiplicity(grid.ndim, B)


def _gradient_from_form(per_elem: torch.Tensor, grid: Grid) -> torch.Tensor:
    return per_elem / (grid.volume * _multiplicity(grid.ndim, per_elem))


def homogenized_elasticity_tensor(
    w: torch.Tensor,
    rho: torch.Tensor,
    grid: Grid,
    material: el.IsotropicMaterial,
    K0=None,
) -> torch.Tensor:
    """Homogenized tensor as the engineering-Voigt D, (S, S), from the
    energy identity: e^s : C_h : e^t = (1/|Y|) sum_e rho_e int_e
    (e^s + eps(w^s)) : C : (e^t + eps(w^t))."""
    if K0 is None:
        degrees = tuple([grid.degree] * grid.ndim)
        K0 = el.element_stiffness_matrix(degrees, grid.stretchings, material)
    return _tensor_from_form(_energy_form_per_element(w, grid, material, K0), rho, grid)


def homogenized_tensor_gradient(
    w: torch.Tensor,
    grid: Grid,
    material: el.IsotropicMaterial,
    K0,
) -> torch.Tensor:
    """d(Eh)/d(rho_e), shape (dims..., S, S): each element's energy form
    over |Y| m_s m_t (engineering Voigt)."""
    return _gradient_from_form(_energy_form_per_element(w, grid, material, K0), grid)


def homogenize(rho: torch.Tensor, grid: Grid, material: el.IsotropicMaterial, K0,
               tol: float = 1e-8, max_iter: int = 2000, use_kernels="auto",
               fine_kernel: str = "flat32"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Eh, dEh/drho, CG iterations per cell problem) of a density field:
    the cell problems as :func:`solve_cell_problems` solves them, then the
    tensor and its gradient from one energy form."""
    K0 = _as_k0(K0, rho)
    w, iters = _solve_cells(rho, grid, material, K0, tol, max_iter, use_kernels,
                            fine_kernel)
    per_elem = _energy_form_per_element(w, grid, material, K0)
    return (_tensor_from_form(per_elem, rho, grid), _gradient_from_form(per_elem, grid),
            iters)


# ---------------------------------------------------------------------------
# Closest isotropic tensor (NumPy)
# ---------------------------------------------------------------------------

def closest_isotropic_lame(C_full: np.ndarray) -> Tuple[float, float]:
    """Frobenius-closest isotropic tensor's (lambda, mu) from a rank-4
    elasticity tensor via the J/K (hydrostatic/deviatoric) projection."""
    N = C_full.shape[0]
    C_ijij = np.einsum("ijij->", C_full)
    C_iijj = np.einsum("iijj->", C_full)
    n = float(N)
    CdotJ = C_iijj / n
    CdotK = C_ijij - CdotJ
    KdotK = 0.5 * (n * n + n) - 1.0
    alpha = CdotJ
    beta = CdotK / KdotK
    lam = (alpha - beta) / n
    mu = beta / 2.0
    return lam, mu


def isotropic_voigt(lam: float, mu: float, ndim: int) -> np.ndarray:
    """Engineering-Voigt D of an isotropic tensor (lam + 2mu on the normal
    diagonal, lam off-normal, mu on shear)."""
    S = num_strains(ndim)
    D = np.zeros((S, S))
    D[:ndim, :ndim] = lam
    for i in range(ndim):
        D[i, i] += 2 * mu
    for s in range(ndim, S):
        D[s, s] = mu
    return D


def voigt_to_full(D: np.ndarray, ndim: int) -> np.ndarray:
    """Engineering-Voigt D -> rank-4 tensor (every minor-symmetric copy
    C_ijkl equals the corresponding D entry)."""
    vs = voigt_strains(ndim)
    S = vs.shape[0]
    C = np.zeros((ndim,) * 4)
    for s in range(S):
        i, j = np.argwhere(vs[s])[0]
        for t in range(S):
            k, l = np.argwhere(vs[t])[0]
            val = D[s, t]
            for (a, b) in ((i, j), (j, i)):
                for (c, d) in ((k, l), (l, k)):
                    C[a, b, c, d] = val
    return C
