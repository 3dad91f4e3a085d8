"""Evaluation library: query trained fields at any resolution
(counterpart of ``ndr_tpu/eval/evaluate.py``).

The paper's mesh-independence evaluation: query a trained neural field,
or upsample a voxel density, at a test resolution that may exceed the
training one, and re-solve for compliance and binary compliance on a
fresh simulator. On the card the solve is fp32 MGPCG with float64
refinement (the kernels on); on the CPU it is float64.

:func:`resize` (from ``ops/resize.py``) is ``jax.image.resize`` for
"nearest", "linear" and "cubic".
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.models.mlp import FourierFeatureMLP, mlp_apply_chunked
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.ops.resize import resize  # noqa: F401 (re-exported)
from ndr_tpu_torch.training.neural import get_mgrid


@dataclasses.dataclass
class EvalResult:
    compliance: float
    binary_compliance: float
    binary_volume: float
    density: np.ndarray
    cg_iters: Tuple[int, int] = (0, 0)  # of the soft and the binary solve


def default_dtype(device) -> torch.dtype:
    """The evaluation's working dtype: fp32 (float64-refined) on the
    card, float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def make_compliance_evaluator(
    cfg: ProblemConfig,
    dims,
    multigrid_levels: int = 1,
    tol: float = 1e-7,
    mg_iterations: int = 2,
    smoother: str = "gs",
    dtype: Optional[torch.dtype] = None,
    device="cuda",
):
    """Fresh simulator and solver at the test resolution; returns
    ``(prob, grid, compliance)`` with ``compliance(rho) -> (2 * 1/2 f^T u,
    cg_iters)``. The defaults are the JAX package's (mgl=1, tol=1e-7,
    two MG iterations, GS smoothing, 200 CG iterations)."""
    dtype = dtype or default_dtype(device)
    prob, grid = problem_from_config(cfg, dims=dims, dtype=dtype, device=device)
    settings = mg.MGSolverSettings(
        num_levels=multigrid_levels, cg_iter=200, tol=tol,
        mg_iterations=mg_iterations, smoother=smoother,
    )
    solve = mg.make_mg_solver(prob, settings)

    def compliance(rho):
        with torch.no_grad():
            u, iters = solve(rho, None)
            return float(2.0 * topopt.compliance_with_adjoint(rho, u, prob)), iters

    return prob, grid, compliance


def _evaluate(rho: torch.Tensor, compliance) -> EvalResult:
    c, it = compliance(rho)
    binary = (rho > 0.5).to(rho.dtype)
    cb, it_b = compliance(binary)
    return EvalResult(compliance=c, binary_compliance=cb,
                      binary_volume=float(binary.mean()),
                      density=rho.cpu().numpy(), cg_iters=(it, it_b))


def evaluate_density(cfg: ProblemConfig, density, dims=None, device="cuda",
                     **solver_kwargs) -> EvalResult:
    """Compliance and binary compliance of a density field."""
    density = np.asarray(density)
    dims = dims or density.shape
    prob, grid, compliance = make_compliance_evaluator(cfg, dims, device=device,
                                                       **solver_kwargs)
    result = _evaluate(torch.as_tensor(density).to(prob.force), compliance)
    result.density = density
    return result


def evaluate_model_at_resolution(
    cfg: ProblemConfig,
    model: FourierFeatureMLP,
    test_dims,
    volume_constraint_satisfier: str = "constrained_sigmoid",
    device="cuda",
    **solver_kwargs,
) -> EvalResult:
    """Query the neural field at any (often higher) resolution and
    evaluate it: the paper's mesh-independence evaluation. The network
    runs in the problem's dtype (a copy where ``model`` has another)."""
    prob, grid, compliance = make_compliance_evaluator(cfg, test_dims, device=device,
                                                       **solver_kwargs)
    dtype = prob.force.dtype
    if model.B.dtype != dtype or model.B.device != prob.device:
        model = copy.deepcopy(model).to(device=prob.device, dtype=dtype)
    coords = get_mgrid(grid.dims, dtype=dtype, device=prob.device)
    with torch.no_grad():
        # chunked: the full-grid Fourier embedding is (n, 2 * embed)
        out = mlp_apply_chunked(model, coords)[..., 0]
        if vol.is_hard_mode(volume_constraint_satisfier):
            rho = vol.satisfy_volume_constraint(out, cfg.max_volume,
                                                mode=volume_constraint_satisfier)
        else:
            rho = torch.clamp(out, 0.0, 1.0)
    return _evaluate(rho, compliance)


def upsample_density(density: torch.Tensor, new_dims) -> torch.Tensor:
    """Linear (bi-/trilinear) resampling of a voxel density to ``new_dims``."""
    return resize(torch.as_tensor(density), tuple(new_dims), method="linear")
