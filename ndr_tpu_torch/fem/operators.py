"""Matrix-free voxel-grid elasticity operators in plain PyTorch
(counterpart of ``ndr_tpu/fem/operators.py``).

These are the always-correct reference ops: the CUDA kernels in
:mod:`ndr_tpu_torch.fem.kernels` are held to them, and they run wherever
the kernels are off. Public layouts are the JAX package's: a node field
``u`` is ``nodes_per_dim + (N,)`` (component-minor), ``young`` is
``dims`` and a per-element stiffness stack ``Ke`` is
``dims + (d_pe, d_pe)``.

Element gather/scatter is written as shifted strided slices of the node
field, as in the JAX package; the per-element matvec is one
``(d_pe, d_pe) @ (d_pe, num_elements)`` matmul.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.utils import timers


def local_node_offsets(grid: Grid) -> np.ndarray:
    """Local node multi-indices (C order), shape (nodes_per_elem, N)."""
    ranges = [range(grid.degree + 1) for _ in grid.dims]
    return np.array(list(itertools.product(*ranges)), dtype=np.int64)


def _elem_slice(grid: Grid, offset: Sequence[int]) -> Tuple[slice, ...]:
    """Strided node-grid slice selecting local node `offset` of every element."""
    d = grid.degree
    return tuple(
        slice(int(o), int(o) + n * d, d) for o, n in zip(offset, grid.dims)
    )


def element_young_modulus(rho: torch.Tensor, E0, Emin, gamma) -> torch.Tensor:
    """SIMP interpolation E = Emin + rho^gamma (E0 - Emin)."""
    return Emin + rho ** gamma * (E0 - Emin)


def _gather_dofs(u: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Element DOFs as rows (node-major, component-minor): (d_pe, ne)."""
    offs = local_node_offsets(grid)
    rows = [
        u[_elem_slice(grid, o) + (d,)].reshape(-1)
        for o in offs
        for d in range(grid.ndim)
    ]
    return torch.stack(rows)


def _scatter_forces(F: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Scatter-add per-element forces (npe, N, dims...) to a node field."""
    N = grid.ndim
    offs = local_node_offsets(grid)
    out = torch.zeros(grid.nodes_per_dim + (N,), dtype=F.dtype,
                      device=F.device)
    for d in range(N):
        out_d = out[..., d]
        for j, o in enumerate(offs):
            out_d[_elem_slice(grid, o)] += F[j, d]
    return out


def gather_element_displacements(u: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Nodal vectors of every element: (dims..., nodes_per_elem, N),
    local nodes in C order (the JAX package's layout). ``u`` may carry
    leading batch axes before its node axes."""
    lead = (slice(None),) * (u.dim() - grid.ndim - 1)
    return torch.stack([u[lead + _elem_slice(grid, o)]
                        for o in local_node_offsets(grid)], dim=-2)


def scatter_element_forces(fe: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Scatter-add per-element nodal forces (dims..., nodes_per_elem, N)
    to a node field nodes_per_dim + (N,), local node by local node (leading
    batch axes of ``fe`` stay leading axes of the field)."""
    lead = fe.shape[:fe.dim() - grid.ndim - 2]
    out = fe.new_zeros(lead + grid.nodes_per_dim + (grid.ndim,))
    for j, o in enumerate(local_node_offsets(grid)):
        out[(Ellipsis,) + _elem_slice(grid, o) + (slice(None),)] += fe[..., j, :]
    return out


def apply_k(
    u: torch.Tensor,
    young: torch.Tensor,
    K0: torch.Tensor,
    grid: Grid,
) -> torch.Tensor:
    """Matrix-free stiffness apply  f = K(E) u  (no Dirichlet handling).

    Args:
      u: node displacement field, nodes_per_dim + (N,).
      young: per-element Young modulus field, shape ``dims``.
      K0: full-density element stiffness (d_pe, d_pe); cast to u's dtype.
    """
    U = _gather_dofs(u, grid)                             # (d_pe, ne)
    F = K0.to(u.dtype) @ U
    F = F * young.reshape(-1)[None, :]
    return _scatter_forces(F.reshape(grid.nodes_per_elem, grid.ndim,
                                     *grid.dims), grid)


def apply_k_cached(
    u: torch.Tensor,
    Ke: torch.Tensor,
    grid: Grid,
) -> torch.Tensor:
    """Stiffness apply with per-element stiffness matrices
    ``Ke`` (dims..., d_pe, d_pe) — the Galerkin-coarsened levels."""
    d_pe = grid.nodes_per_elem * grid.ndim
    U = _gather_dofs(u, grid)                             # (d_pe, ne)
    Kef = Ke.reshape(-1, d_pe, d_pe).to(u.dtype)          # (ne, d, d)
    F = torch.bmm(Kef, U.t().unsqueeze(-1)).squeeze(-1).t()
    return _scatter_forces(F.reshape(grid.nodes_per_elem, grid.ndim,
                                     *grid.dims), grid)


def node_diag_blocks(
    young: torch.Tensor, K0: torch.Tensor, grid: Grid
) -> torch.Tensor:
    """Per-node NxN diagonal blocks of the stiffness matrix,
    M[n] = sum over incident elements e of E_e * K0[local(n), local(n)].

    Written as 2^N shifted-slice adds (the JAX package uses one
    convolution; a cuDNN convolution would pick its own algorithm and
    accuracy, the slice adds are exact and deterministic).

    Returns nodes_per_dim + (N, N).
    """
    N = grid.ndim
    npe = grid.nodes_per_elem
    K0r = K0.to(young.dtype).reshape(npe, N, npe, N)
    out = torch.zeros(grid.nodes_per_dim + (N, N), dtype=young.dtype,
                      device=young.device)
    for j, o in enumerate(local_node_offsets(grid)):
        out[_elem_slice(grid, o)] += young[..., None, None] * K0r[j, :, j, :]
    return out


def node_diag_blocks_cached(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Per-node diagonal blocks from per-element stiffness matrices."""
    N = grid.ndim
    npe = grid.nodes_per_elem
    Ker = Ke.reshape(grid.dims + (npe, N, npe, N))
    out = torch.zeros(grid.nodes_per_dim + (N, N), dtype=Ke.dtype,
                      device=Ke.device)
    for j, o in enumerate(local_node_offsets(grid)):
        out[_elem_slice(grid, o)] += Ker[..., j, :, j, :]
    return out


def node_diag_blocks_from_elem_diag(ke_diag: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Per-node diagonal blocks from per-element *diagonal-only* blocks
    (dims..., npe, N, N): the levels whose full Ke is not materialized."""
    N = grid.ndim
    out = torch.zeros(grid.nodes_per_dim + (N, N), dtype=ke_diag.dtype,
                      device=ke_diag.device)
    for j, o in enumerate(local_node_offsets(grid)):
        out[_elem_slice(grid, o)] += ke_diag[..., j, :, :]
    return out


def invert_blocks(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 2x2 / 3x3 SPD blocks (..., N, N)."""
    n = M.shape[-1]
    if n == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack(
            [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
        )
        return inv / det[..., None, None]
    if n == 3:
        m = [[M[..., i, j] for j in range(3)] for i in range(3)]
        c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
        c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
        c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
        c10 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
        c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
        c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
        c20 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
        c21 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
        c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        det = m[0][0] * c00 + m[0][1] * c10 + m[0][2] * c20
        inv = torch.stack(
            [
                torch.stack([c00, c01, c02], -1),
                torch.stack([c10, c11, c12], -1),
                torch.stack([c20, c21, c22], -1),
            ],
            -2,
        )
        return inv / det[..., None, None]
    raise NotImplementedError(f"block size {n}")


def zero_dirichlet(u: torch.Tensor, dirichlet_mask: torch.Tensor) -> torch.Tensor:
    """Zero out Dirichlet-constrained components."""
    return u.masked_fill(dirichlet_mask, 0.0)


def compliance_gradient(
    u: torch.Tensor,
    rho: torch.Tensor,
    K0: torch.Tensor,
    grid: Grid,
    E0,
    Emin,
    gamma,
) -> torch.Tensor:
    """Adjoint gradient of compliance (1/2 f^T u) w.r.t. densities,
    g_e = -0.5 * gamma * rho^(gamma-1) * (E0-Emin) * u_e^T K0 u_e."""
    U = _gather_dofs(u, grid)                             # (d_pe, ne)
    K0U = K0.to(u.dtype) @ U
    utku = (U * K0U).sum(dim=0).reshape(grid.dims)
    return -0.5 * gamma * rho ** (gamma - 1.0) * (E0 - Emin) * utku


def element_node_flat_indices(grid: Grid) -> np.ndarray:
    """Global flat node index of each element's local nodes, (ne, npe)."""
    offs = local_node_offsets(grid)
    nodes_pd = grid.nodes_per_dim
    elem_idx = np.array(
        list(itertools.product(*[range(n) for n in grid.dims])), dtype=np.int64
    )  # (ne, N) in C order
    first = elem_idx * grid.degree
    glob = first[:, None, :] + offs[None, :, :]        # (ne, npe, N)
    strides = np.cumprod([1] + list(nodes_pd[::-1][:-1]))[::-1]
    return glob @ strides


# ---------------------------------------------------------------------------
# Dense assembly (NumPy; test oracles and tiny direct solves only)
# ---------------------------------------------------------------------------

def assemble_dense_k(young: np.ndarray, K0: np.ndarray, grid: Grid) -> np.ndarray:
    """The full dense stiffness matrix (small grids only), DOFs
    node-major, component-minor."""
    N = grid.ndim
    n_dofs = grid.num_nodes * N
    K = np.zeros((n_dofs, n_dofs))
    enodes = element_node_flat_indices(grid)
    E = np.asarray(young).ravel()
    K0 = np.asarray(K0)
    for e in range(grid.num_elements):
        dofs = np.stack([N * enodes[e] + c for c in range(N)], axis=1).ravel()
        K[np.ix_(dofs, dofs)] += E[e] * K0
    return K


def pin_dirichlet(K: torch.Tensor, dirichlet_mask: torch.Tensor) -> torch.Tensor:
    """Zero the fixed rows and columns of a dense K in place and put 1 on
    their diagonal (zero-value Dirichlet conditions); returns K."""
    idx = torch.nonzero(dirichlet_mask.reshape(-1)).reshape(-1)
    timers.count("host_reads")   # nonzero reads its count back
    K[idx, :] = 0.0
    K[:, idx] = 0.0
    K[idx, idx] = 1.0
    return K


def pin_dirichlet_dense(K: np.ndarray, mask_flat: np.ndarray) -> np.ndarray:
    """:func:`pin_dirichlet` on a copy of a NumPy K."""
    return pin_dirichlet(torch.tensor(K), torch.as_tensor(np.asarray(mask_flat))).numpy()
