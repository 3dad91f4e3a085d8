"""Evaluation library: query trained fields at any resolution
(counterpart of ``ndr_tpu/eval/evaluate.py``).

The paper's mesh-independence evaluation: query a trained neural field,
or upsample a voxel density, at a test resolution that may exceed the
training one, and re-solve for compliance and binary compliance on a
fresh simulator. On the card the solve is fp32 MGPCG with float64
refinement (the kernels on); on the CPU it is float64.

:func:`resize` is ``jax.image.resize`` for "nearest", "linear" and
"cubic": half-pixel centres, per-axis weight matrices renormalized at the
edges and, when shrinking, a kernel widened by the scale (antialiasing).
Its "cubic" is Keys' kernel with a = -0.5.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.models.mlp import FourierFeatureMLP, mlp_apply_chunked
from ndr_tpu_torch.ops import volume as vol
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


# ---------------------------------------------------------------------------
# jax.image.resize
# ---------------------------------------------------------------------------

def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float64 weights of one axis of :func:`resize`
    ("linear" or "cubic")."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)      # widen the kernel when shrinking
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    # fp32 arithmetic, as jax.image.resize computes it
    f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(f).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for "nearest", "linear" and
    "cubic" (antialiased when shrinking): every axis whose size changes is
    resampled, one axis at a time."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match {tuple(x.shape)}")
    if method not in ("nearest", "linear", "cubic"):
        raise ValueError(f"unknown resize method {method!r}")
    if method != "nearest" and not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = torch.as_tensor(_nearest_index(m, n), device=x.device)
            x = x.index_select(d, idx)
        else:
            w = torch.as_tensor(_resize_weights(m, n, method), dtype=x.dtype,
                                device=x.device)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def upsample_density(density: torch.Tensor, new_dims) -> torch.Tensor:
    """Linear (bi-/trilinear) resampling of a voxel density to ``new_dims``."""
    return resize(torch.as_tensor(density), tuple(new_dims), method="linear")
