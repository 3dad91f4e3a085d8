"""Linear solvers: preconditioned CG, and dense assembly and Cholesky for
the coarsest multigrid level and as test oracles (counterpart of
``ndr_tpu/fem/solvers.py``).

The MGPCG driver lives in :mod:`ndr_tpu_torch.fem.multigrid`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.fem import operators as ops


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def assemble_dense_k_traced(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Assemble the dense K (n_dofs, n_dofs) from per-element matrices
    ``Ke`` (dims..., d_pe, d_pe) on Ke's device.

    One ``index_add_`` per local node a, of the rows of a in every
    element: within one call no two entries share a target (an element's
    node a is no other element's), so the sums take the order of a on
    every device and every run (one call over all elements would add the
    shared targets with atomics, in no fixed order, on CUDA)."""
    N = grid.ndim
    n_dofs = grid.num_nodes * N
    enodes = ops.element_node_flat_indices(grid)          # (ne, npe) numpy
    dofs = np.stack(
        [N * enodes + c for c in range(N)], axis=-1
    ).reshape(grid.num_elements, -1)                      # (ne, d_pe)
    Ke = Ke.reshape(grid.num_elements, dofs.shape[1], dofs.shape[1])
    K = torch.zeros(n_dofs * n_dofs, dtype=Ke.dtype, device=Ke.device)
    for a in range(grid.nodes_per_elem):
        rows = slice(a * N, (a + 1) * N)
        flat = (dofs[:, rows, None] * n_dofs + dofs[:, None, :]).reshape(-1)
        K.index_add_(0, torch.as_tensor(flat, device=Ke.device),
                     Ke[:, rows, :].reshape(-1))
    return K.reshape(n_dofs, n_dofs)


def dense_pinned_matrix(young, K0, dirichlet_mask, grid: Grid) -> np.ndarray:
    """Dense stiffness matrix with the Dirichlet DOFs pinned (NumPy)."""
    K = ops.assemble_dense_k(np.asarray(young), np.asarray(K0), grid)
    return ops.pin_dirichlet_dense(K, np.asarray(dirichlet_mask).reshape(-1))


def dense_solve(young: torch.Tensor, K0: torch.Tensor,
                dirichlet_mask: torch.Tensor, f: torch.Tensor,
                grid: Grid) -> torch.Tensor:
    """Direct dense Cholesky solve of K(young) u = f with zero Dirichlet
    values (small grids only: the oracle of the iterative solves)."""
    Ke = young[..., None, None] * K0.to(young.dtype)
    dcs = DenseCoarseSolver(grid)
    return dcs.solve(dcs.factor(Ke, dirichlet_mask), f.to(young.dtype), dirichlet_mask)


class DenseCoarseSolver:
    """Exact Cholesky solve of a level's pinned dense K from its
    per-element stack."""

    def __init__(self, grid: Grid):
        self.grid = grid

    def factor(self, Ke: torch.Tensor, dirichlet_mask: torch.Tensor) -> torch.Tensor:
        """The lower Cholesky factor of the pinned dense K."""
        K = ops.pin_dirichlet(assemble_dense_k_traced(Ke, self.grid), dirichlet_mask)
        return torch.linalg.cholesky(K)

    def solve(self, chol: torch.Tensor, b: torch.Tensor,
              dirichlet_mask: torch.Tensor) -> torch.Tensor:
        rhs = b.reshape(-1).masked_fill(dirichlet_mask.reshape(-1), 0.0)
        return torch.cholesky_solve(rhs[:, None], chol)[:, 0].reshape(b.shape)


def conjugate_gradient(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: Union[float, torch.Tensor] = 1e-5,
    max_iter: int = 1000,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, int]:
    """(Preconditioned) conjugate gradient with ||Ax-b|| <= tol*||b||.

    The restructured PCG of ``ndr_tpu.fem.solvers.conjugate_gradient``:
    the preconditioner is applied at the top of the loop and the stop
    test is on the force residual relative to ||b||. ``apply_a`` must
    encode the Dirichlet projection; ``b`` and ``x0`` must be zero on
    constrained components. The stop test reads one scalar back to the
    host per iteration.

    Returns (x, iterations).
    """
    if precond is None:
        precond = lambda r: r
    b_norm_sq = _dot(b, b)
    # tol*tol*||b||^2 in b's dtype, as the JAX package evaluates it
    if isinstance(tol, torch.Tensor):
        thresh = tol.to(b.dtype) * tol.to(b.dtype) * b_norm_sq
    else:
        thresh = b_norm_sq.new_tensor(tol * tol) * b_norm_sq
    x = x0
    r = b - apply_a(x0)
    d = torch.zeros_like(b)
    r_minv_r_old = None
    i = 0
    while i < max_iter and bool(_dot(r, r) > thresh):
        s = precond(r)
        r_minv_r = _dot(r, s)
        d = s if i == 0 else s + (r_minv_r / r_minv_r_old) * d
        ad = apply_a(d)
        alpha = r_minv_r / _dot(d, ad)
        x = x + alpha * d
        r = r - alpha * ad
        r_minv_r_old = r_minv_r
        i += 1
    return x, i


def conjugate_gradient_batched(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-5,
    max_iter: int = 1000,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """S independent systems at once (leading axis S of ``b`` and ``x0``):
    :func:`conjugate_gradient` mapped over that axis, as ``jax.vmap`` maps
    ``ndr_tpu.fem.solvers.conjugate_gradient``.

    ``apply_a`` and ``precond`` act on the whole batch. Each column has its
    own alpha, beta, stop test and count; a column whose stop test holds is
    frozen (its x, r, d and count stop changing; a column with b = 0 starts
    frozen), and the loop runs while any column is active and below
    ``max_iter``. The branch computed for a frozen column may hold NaN
    (0/0 once its residual is exactly zero); ``torch.where`` keeps it out of
    the kept values. One host read per iteration: is any column active?

    Returns (x, iterations per column, shape (S,))."""
    if precond is None:
        precond = lambda r: r
    S = b.shape[0]
    col = (S,) + (1,) * (b.dim() - 1)

    def dots(a, c):
        return torch.linalg.vecdot(a.reshape(S, -1), c.reshape(S, -1))

    thresh = tol * tol * dots(b, b)
    x = x0
    r = b - apply_a(x0)
    d = torch.zeros_like(b)
    rmr_old = torch.ones(S, dtype=b.dtype, device=b.device)
    iters = torch.zeros(S, dtype=torch.int64, device=b.device)
    # an active column has taken exactly k steps: the i < max_iter and
    # i == 0 tests of the unbatched loop are tests of k
    k = 0
    while k < max_iter:
        active = dots(r, r) > thresh
        if not bool(active.any()):
            break
        s = precond(r)
        rmr = dots(r, s)
        d_new = s if k == 0 else s + (rmr / rmr_old).reshape(col) * d
        ad = apply_a(d_new)
        alpha = (rmr / dots(d_new, ad)).reshape(col)
        keep = active.reshape(col)
        x = torch.where(keep, x + alpha * d_new, x)
        r = torch.where(keep, r - alpha * ad, r)
        d = torch.where(keep, d_new, d)
        rmr_old = torch.where(active, rmr, rmr_old)
        iters += active
        k += 1
    return x, iters
