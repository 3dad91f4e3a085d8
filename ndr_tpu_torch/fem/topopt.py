"""Topology-optimization problem layer: objective, filters, constraint, OC
(counterpart of ``ndr_tpu/fem/topopt.py``).

The compliance objective exposes its closed-form adjoint gradient
through a ``torch.autograd.Function``: the linear solve is never
differentiated through. Filter-chain backprop is ordinary autograd.

JAX runs the OC bracket expansion and bisection as device while-loops;
here they are host loops that read one scalar back per volume
evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import FEMProblem
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.ops.filters import Filter, apply_filter_chain


# ---------------------------------------------------------------------------
# Linear solves (the mgl=0 plain-CG path)
# ---------------------------------------------------------------------------

def block_jacobi_preconditioner(prob: FEMProblem, rho: torch.Tensor):
    """Per-node NxN block-diagonal preconditioner M^-1."""
    young = prob.young(rho)
    inv = ops.invert_blocks(ops.node_diag_blocks(young, prob.K0, prob.grid))

    def apply(r):
        s = (inv * r.unsqueeze(-2)).sum(-1)
        return ops.zero_dirichlet(s, prob.dirichlet_mask)

    return apply


def solve_displacement_cg(
    prob: FEMProblem,
    rho: torch.Tensor,
    u0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    max_iter: int = 5000,
    preconditioned: bool = True,
) -> Tuple[torch.Tensor, int]:
    """Equilibrium solve K(rho) u = f with (block-Jacobi) CG."""
    young = prob.young(rho)

    def apply_a(u):
        return prob.zero_dirichlet(
            ops.apply_k(prob.zero_dirichlet(u), young, prob.K0, prob.grid))

    b = prob.zero_dirichlet(prob.force)
    u0 = torch.zeros_like(b) if u0 is None else prob.zero_dirichlet(u0.to(b.dtype))
    precond = block_jacobi_preconditioner(prob, rho) if preconditioned else None
    return solvers.conjugate_gradient(apply_a, b, u0, tol=tol,
                                      max_iter=max_iter, precond=precond)


# ---------------------------------------------------------------------------
# Compliance with closed-form adjoint
# ---------------------------------------------------------------------------

def _compliance(force: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(force.dtype, u.dtype)
    return 0.5 * torch.dot(force.reshape(-1).to(dt), u.reshape(-1).to(dt))


class _ComplianceWithAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rho, u, prob):
        ctx.save_for_backward(rho, u)
        ctx.prob = prob
        return _compliance(prob.force, u)

    @staticmethod
    def backward(ctx, g):
        rho, u = ctx.saved_tensors
        # the adjoint gradient needs only rho's working precision: u is
        # cast down so the gradient contraction stays fp32 even when the
        # mixed-precision solver returns a float64 equilibrium
        grad = ctx.prob.compliance_gradient(u.to(rho.dtype), rho)
        return (g * grad).to(rho.dtype), None, None


def compliance_with_adjoint(rho: torch.Tensor, u: torch.Tensor,
                            prob: FEMProblem) -> torch.Tensor:
    """compliance = 1/2 f^T u, with d/d(rho) from the self-adjoint closed
    form (u is the equilibrium of K(rho) u = f; no gradient flows into u)."""
    return _ComplianceWithAdjoint.apply(rho, u.detach(), prob)


# ---------------------------------------------------------------------------
# Topology-optimization problem (filters + constraint + objective)
# ---------------------------------------------------------------------------

SolveFn = Callable[[torch.Tensor, Optional[torch.Tensor]], Tuple[torch.Tensor, int]]


@dataclasses.dataclass
class TopologyOptimizationProblem:
    """Bundles simulator + filter chain + volume constraint + solver."""

    prob: FEMProblem
    filters: Sequence[Filter]
    max_volume: float
    solve: SolveFn  # (rho, u0) -> (u, iters)

    def physical_density(self, x: torch.Tensor) -> torch.Tensor:
        return apply_filter_chain(x, self.filters)

    def objective(self, x, u0=None, precond=None):
        """Returns (compliance, u, cg_iters); compliance = 1/2 f^T u.
        ``precond``: a lagged preconditioner for the MGPCG solve
        (``solve.build_precond``)."""
        with torch.no_grad():
            rho = self.physical_density(x)
            if precond is None:
                u, iters = self.solve(rho, u0)
            else:
                u, iters = self.solve(rho, u0, precond=precond)
            c = _compliance(self.prob.force, u)
        return c, u, iters

    def objective_gradient(self, x, u):
        """d(compliance)/d(design x): closed-form adjoint + filter backprop."""
        xx = x.detach().requires_grad_(True)
        c = compliance_with_adjoint(self.physical_density(xx), u, self.prob)
        return torch.autograd.grad(c, xx)[0]

    def constraint(self, x):
        return vol.total_volume_constraint(self.physical_density(x),
                                           self.max_volume)

    def constraint_gradient(self, x):
        xx = x.detach().requires_grad_(True)
        return torch.autograd.grad(self.constraint(xx), xx)[0]


# ---------------------------------------------------------------------------
# Optimality-criteria optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OCState:
    """Carried OC state: design vars, warm-start u, and the lambda bracket
    (host scalars holding values of x's dtype)."""

    x: torch.Tensor
    u: torch.Tensor
    lambda_min: float
    lambda_max: float


def _scalar_type(t: torch.Tensor):
    return np.float32 if t.dtype == torch.float32 else np.float64


def oc_init(top: TopologyOptimizationProblem, x0: torch.Tensor,
            u_dtype: Optional[torch.dtype] = None) -> OCState:
    """`u_dtype` should match the solver's output dtype (float64 for the
    mixed-precision MGPCG)."""
    u_dtype = u_dtype or top.prob.force.dtype
    return OCState(
        x=x0,
        u=torch.zeros(top.prob.force.shape, dtype=u_dtype, device=x0.device),
        lambda_min=1.0,
        lambda_max=2.0,
    )


def oc_state_from_numpy(state: dict, device) -> OCState:
    """An OCState from numpy arrays, e.g. an ``ndr_tpu`` OCState's fields
    ``x``, ``u``, ``lambda_min`` and ``lambda_max``."""
    return OCState(
        x=torch.tensor(np.asarray(state["x"]), device=device),
        u=torch.tensor(np.asarray(state["u"]), device=device),
        lambda_min=float(np.asarray(state["lambda_min"])),
        lambda_max=float(np.asarray(state["lambda_max"])),
    )


def oc_step(
    top: TopologyOptimizationProblem,
    state: OCState,
    m: float = 0.2,
    ctol: float = 1e-6,
    precond=None,
):
    """One Optimality-Criteria step (``precond``: a lagged preconditioner
    state, passed to the solve).

    x <- clip(x * sqrt(dJ / (lambda dc)), [x - m, x + m] ∩ [0, 1]) with
    lambda found by bracketed bisection on the volume constraint of the
    filtered stepped variables (at most 100 bisection steps: in float32
    the volume mean has ~1e-7 rounding noise and ctol may be unreachable).
    Scalar arithmetic is in x's dtype, as in the JAX package.

    Returns (new_state, metrics dict of host numbers).
    """
    x0 = state.x
    st = _scalar_type(x0)
    c, u, iters = top.objective(x0, state.u, precond=precond)
    dJ = top.objective_gradient(x0, u)
    dc = top.constraint_gradient(x0)
    lo = torch.clamp(x0 - m, min=0.0)
    hi = torch.clamp(x0 + m, max=1.0)

    def stepped_vars(lam):
        ratio = dJ / (dc * float(lam))
        step = x0 * torch.sqrt(torch.clamp(ratio, min=0.0))
        return torch.minimum(torch.maximum(step, lo), hi)

    def ceval(lam) -> float:
        with torch.no_grad():
            v = vol.total_volume_constraint(
                top.physical_density(stepped_vars(lam)), top.max_volume)
        return st(v.item())

    lam_min, lam_max = st(state.lambda_min), st(state.lambda_max)
    while ceval(lam_min) > 0:            # expand the bracket downward
        lam_min, lam_max = lam_min * st(0.5), lam_min
    while ceval(lam_max) < 0:            # expand the bracket upward
        lam_min, lam_max = lam_max, lam_max * st(2.0)

    lam_mid = st(0.5) * (lam_min + lam_max)
    v = ceval(lam_mid)
    it = 0
    while abs(v) > st(ctol) and it < 100:
        if v < 0:
            lam_min = lam_mid
        if v > 0:
            lam_max = lam_mid
        lam_mid = st(0.5) * (lam_min + lam_max)
        v = ceval(lam_mid)
        it += 1

    with torch.no_grad():
        x_new = stepped_vars(lam_mid)
    new_state = OCState(x=x_new, u=u, lambda_min=float(lam_min),
                        lambda_max=float(lam_max))
    metrics = {
        "compliance": float(c),
        "constraint": float(v),
        "lambda": float(lam_mid),
        "cg_iters": int(iters),
    }
    return new_state, metrics
