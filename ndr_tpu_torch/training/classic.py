"""Classic SIMP topology optimization, the ground-truth path
(counterpart of ``ndr_tpu/training/classic.py``).

Smoothing + projection filters, total-volume constraint, MGPCG
compliance objective (tol=1e-4, FMG, 1 MG iteration, 2 smoothing sweeps,
warm-started), OC optimizer, run as a host loop of eager steps.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.ops import filters as flt
from ndr_tpu_torch.utils import timers


@dataclasses.dataclass
class ClassicResult:
    densities: np.ndarray          # final *design* variables
    physical: np.ndarray           # final filtered densities
    compliance: float              # 2 * (1/2 f^T u), the reference's loss convention
    binary_compliance: float
    history: List[float]
    seconds: float
    step_seconds: List[float]      # wall time of each OC step (no callbacks)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def ground_truth_topopt(
    cfg: ProblemConfig,
    dims=None,
    max_iter: int = 100,
    multigrid_levels: int = 2,
    use_multigrid: bool = True,
    tol: float = 1e-4,
    smoother: str = "chebyshev",
    use_kernels="auto",
    smoothing_radius: int = 1,
    projection_beta: float = 1.0,
    oc_move: float = 0.2,
    oc_ctol: float = 1e-6,
    cg_iter: Optional[int] = None,
    optimizer: str = "OC",
    init: Optional[np.ndarray] = None,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 1,
    callback=None,
    snapshot_cb=None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    shards: int = 0,
    precond_lag: int = 0,
    scan_chunk: int = 0,
) -> ClassicResult:
    """Run classic SIMP TO with the OC optimizer on ``device``.

    Defaults are ``ndr_tpu``'s: fp32 hot path with float64-refined
    equilibrium, Chebyshev smoother of degree 1 per smoothing sweep.
    """
    if optimizer != "OC":
        _not_ported(f"optimizer={optimizer!r}", "Queue 1 item 11 (ops/lbfgs.py)")
    if (shards if isinstance(shards, int) else max(shards)) > 1:
        _not_ported("shards", "Queue 1 item 13 (parallel/mesh.py)")
    if precond_lag > 1:
        _not_ported("precond_lag > 1", "Queue 1 item 11 (lagged preconditioner)")
    if scan_chunk > 1:
        _not_ported("scan_chunk > 1", "Queue 1 item 11 (device-side chunked loop)")
    device = torch.device(device)
    dtype = dtype or torch.float32
    # mgl=0 means the plain-CG exact-solve path (reference's direct solve)
    use_multigrid = use_multigrid and multigrid_levels > 0
    prob, grid = problem_from_config(cfg, dims=dims, dtype=dtype, device=device)
    filters = [
        flt.SmoothingFilter(radius=smoothing_radius),
        flt.ProjectionFilter(beta=projection_beta),
    ]
    mixed = False
    if use_multigrid:
        if cg_iter is None:
            # un-coarsenable grids degrade to block-Jacobi PCG, which
            # needs far more (much cheaper) iterations
            cg_iter = (2000 if mg.max_feasible_coarsenings(grid) == 0
                       else 100)
        settings = mg.MGSolverSettings(
            num_levels=multigrid_levels,
            cg_iter=cg_iter,
            tol=tol,
            mg_iterations=1,
            mg_smoothing_iterations=2,
            full_multigrid=True,
            zero_init=False,
            smoother=smoother,
            cheb_degree=1,
            use_kernels=use_kernels,
        )
        solve = mg.make_mg_solver(prob, settings)
        mixed = settings.mixed_precision and dtype == torch.float32
    else:
        def solve(rho, u0):
            return topopt.solve_displacement_cg(prob, rho, u0, tol=tol,
                                                max_iter=10000)

    top = topopt.TopologyOptimizationProblem(
        prob=prob, filters=filters, max_volume=cfg.max_volume, solve=solve
    )

    x0 = torch.full(grid.dims, cfg.max_volume, dtype=dtype, device=device)
    if init is not None:
        x0 = torch.as_tensor(np.asarray(init), device=device).to(dtype).reshape(grid.dims)
    state = topopt.oc_init(top, x0, u_dtype=torch.float64 if mixed else dtype)

    history: List[float] = []
    step_seconds: List[float] = []
    t_start = time.perf_counter()
    t_iter = t_start
    with timers.section("OC optimization"):
        for idx in range(max_iter):
            t_step = time.perf_counter()
            state, metrics = topopt.oc_step(top, state, m=oc_move, ctol=oc_ctol)
            now = time.perf_counter()  # oc_step ends on host reads: synced
            step_seconds.append(now - t_step)
            c2 = 2.0 * metrics["compliance"]
            history.append(c2)
            if idx % log_every == 0 or idx == max_iter - 1:
                log(
                    f"Total Steps: {idx}, Runtime: {now - t_iter:.2f}, Compliance loss "
                    f"{c2:.6f}, constraint {metrics['constraint']:.2e}, "
                    f"lambda {metrics['lambda']:.4g}, "
                    f"cg_iters {metrics['cg_iters']}\n"
                )
            t_iter = time.perf_counter()
            if callback is not None:
                callback(idx, state)
            if snapshot_cb is not None:
                snapshot_cb(idx, state,
                            lambda s=state: top.physical_density(s.x))

    # Final evaluation + binary compliance with the reference's semantics:
    # both the binarized field and the final soft field pass through the
    # filter chain again before the solve, so the final soft number is the
    # compliance of the double-filtered design.
    with torch.no_grad():
        rho = top.physical_density(state.x)
        binary = (rho > 0.5).to(dtype)
        u_b, _ = solve(top.physical_density(binary), state.u)
        c_binary = float(torch.dot(prob.force.reshape(-1).to(u_b.dtype),
                                   u_b.reshape(-1)))
        u_s, _ = solve(top.physical_density(rho), state.u)
        c_soft = float(torch.dot(prob.force.reshape(-1).to(u_s.dtype),
                                 u_s.reshape(-1)))

    seconds = time.perf_counter() - t_start
    log(
        f"Compliance loss of binary densities for \"{binary.numel()}\": "
        f"{c_binary}, b-vol={float(binary.mean()):.7f}\n"
    )
    log(
        f"Final step, Compliance loss {c_soft:.6f}, "
        f"Binary Compliance loss {c_binary:.6f}\n"
    )
    log(f"Overall runtime: {seconds:.3f}\n")
    return ClassicResult(
        densities=state.x.cpu().numpy(),
        physical=rho.cpu().numpy(),
        compliance=c_soft,
        binary_compliance=c_binary,
        history=history,
        seconds=seconds,
        step_seconds=step_seconds,
    )
