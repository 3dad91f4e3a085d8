"""Classic SIMP topology optimization, the ground-truth path
(counterpart of ``ndr_tpu/training/classic.py``).

Smoothing + projection filters, total-volume constraint, MGPCG
compliance objective (tol=1e-4, FMG, 1 MG iteration, 2 smoothing sweeps,
warm-started), OC optimizer, run as a host loop of eager steps; or, with
``optimizer="LBFGS"``, the augmented-Lagrangian projected L-BFGS of
:mod:`ndr_tpu_torch.ops.lbfgs` (the reference's IPOPT mode).

``precond_lag`` > 1 rebuilds the multigrid hierarchy every that many
steps (the CG operator stays exact; the lagged hierarchy only
preconditions), and in the host loop early, on the next step, when a
step's CG count exceeds the first lagged solve's by more than 4.
``scan_chunk`` > 1 is the JAX package's device-side chunked loop, whose
chunks replay each preconditioner call from a CUDA graph on CUDA
(``multigrid.PrecondGraph``); callbacks and snapshots run at chunk
boundaries. :mod:`ndr_tpu_torch.training.schedule` runs both loops.
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
from ndr_tpu_torch.ops import lbfgs
from ndr_tpu_torch.training import schedule
from ndr_tpu_torch.utils import timers


@dataclasses.dataclass
class ClassicResult:
    densities: np.ndarray          # final *design* variables
    physical: np.ndarray           # final filtered densities
    compliance: float              # 2 * (1/2 f^T u), the reference's loss convention
    binary_compliance: float
    history: List[float]
    seconds: float
    step_seconds: List[float]      # wall time of each OC step (no callbacks;
                                   # chunked steps: the chunk's wall / chunk;
                                   # LBFGS: of each inner iteration)
    # multigrid.stats (the port's counters and span times, timers.counters)
    # over the OC steps: hierarchy builds, CUDA-graph captures, replays and
    # capture seconds, CG iterations, host reads, ...
    solver_stats: dict = dataclasses.field(default_factory=dict)
    # LBFGS: objective + gradient evaluations (one solve each)
    evaluations: int = 0
    # OC: the CG iterations of each step's solve (summed over its
    # refinement passes), and how many of its passes stopped at the CG cap
    # (``multigrid.stats["cg_passes_at_cap"]``)
    cg_iters: List[int] = dataclasses.field(default_factory=list)
    cg_passes_at_cap: List[int] = dataclasses.field(default_factory=list)


def default_cg_iter(grid) -> int:
    """The CG cap per solve when none is given: 100 for MGPCG, 2000 for
    the block-Jacobi PCG of a grid that cannot coarsen (far more, much
    cheaper iterations)."""
    return 2000 if mg.max_feasible_coarsenings(grid) == 0 else 100


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
    solver_overrides: Optional[dict] = None,
) -> ClassicResult:
    """Run classic SIMP TO with the OC optimizer on ``device``.

    Defaults are ``ndr_tpu``'s: fp32 hot path with float64-refined
    equilibrium, Chebyshev smoother of degree 1 per smoothing sweep.
    ``solver_overrides``: ``MGSolverSettings`` fields to replace (e.g.
    ``{"cached_ke_dtype": "bfloat16"}``; with shards, keywords of the
    sharded solver). ``optimizer``: "OC" or "LBFGS" (``max_iter`` then
    bounds its inner iterations; ``history`` holds 2 c at the start of
    each, then the restored design's). ``shards``: N (slabs) or (NX, NY)
    (pencils) runs the solve over the N or NX * NY ranks of the
    initialized process group (``parallel.launch``; every rank calls this
    function) with the JAX package's sharded solver: Chebyshev smoothing
    whatever ``smoother`` says, no lagged preconditioner or chunked loop.
    """
    if optimizer not in ("OC", "LBFGS"):
        raise ValueError(f"optimizer={optimizer!r}: OC or LBFGS")
    if optimizer == "LBFGS" and (precond_lag > 1 or scan_chunk > 1):
        raise ValueError("optimizer='LBFGS' has neither a lagged preconditioner "
                         "(precond_lag) nor a chunked loop (scan_chunk)")
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
    shards_2d = tuple(shards) if isinstance(shards, (tuple, list)) else None
    sharded = (shards_2d[0] * shards_2d[1] > 1) if shards_2d else shards > 1
    if sharded:
        # the sharded MGPCG (parallel.mesh) over the ranks of the process
        # group replaces the single-device solver; filters, OC and the
        # adjoint run replicated on every rank, on the gathered u
        from ndr_tpu_torch.parallel import mesh as pmesh

        if multigrid_levels < 1:
            raise ValueError("shards need the multigrid solver (multigrid_levels >= 1)")
        kw = dict(num_levels=multigrid_levels, tol=tol, max_iter=cg_iter or 100,
                  mixed_precision=dtype == torch.float32, use_kernels=use_kernels,
                  **(solver_overrides or {}))
        solve = (pmesh.make_sharded_solver_2d(prob, *shards_2d, **kw) if shards_2d
                 else pmesh.make_sharded_solver(prob, shards, **kw))
        mixed = dtype == torch.float32
        log(f"Stiffness applies: {solve.description}\n")
    elif use_multigrid:
        if cg_iter is None:
            cg_iter = default_cg_iter(grid)
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
        settings = dataclasses.replace(settings, **(solver_overrides or {}))
        solve = mg.make_mg_solver(prob, settings)
        mixed = settings.mixed_precision and dtype == torch.float32
        log(f"Stiffness applies: {mg.describe_applies(prob, solve.settings)}\n")
    else:
        def solve(rho, u0):
            return topopt.solve_displacement_cg(prob, rho, u0, tol=tol,
                                                max_iter=10000)
        log("Stiffness applies: plain torch ops (mgl=0: block-Jacobi CG)\n")

    top = topopt.TopologyOptimizationProblem(
        prob=prob, filters=filters, max_volume=cfg.max_volume, solve=solve
    )

    x0 = torch.full(grid.dims, cfg.max_volume, dtype=dtype, device=device)
    if init is not None:
        x0 = torch.as_tensor(np.asarray(init), device=device).to(dtype).reshape(grid.dims)
    state = topopt.oc_init(top, x0, u_dtype=torch.float64 if mixed else dtype)

    history: List[float] = []
    # the MGPCG solver takes a lagged preconditioner; the sharded and the
    # mgl=0 solves build their own
    lagged = hasattr(solve, "build_precond")
    sched = schedule.Schedule(lag=precond_lag if lagged and precond_lag > 1 else 0,
                              scan_chunk=scan_chunk if lagged else 0)
    it_ref = None  # the CG count of the first solve after a build

    def step(precond, rebuild, use_graph):
        nonlocal state, it_ref
        if rebuild:
            with torch.no_grad():
                precond = solve.build_precond(top.physical_density(state.x), into=precond,
                                              use_graph=use_graph)
            it_ref = None
        state, metrics = topopt.oc_step(top, state, m=oc_move, ctol=oc_ctol,
                                        precond=precond)
        if it_ref is None:
            it_ref = metrics["cg_iters"]
        elif metrics["cg_iters"] > it_ref + 4:
            sched.force_rebuild()  # the lagged hierarchy stopped paying
        return metrics, precond

    def notify(i, s):
        if callback is not None:
            callback(i, s)
        if snapshot_cb is not None:
            snapshot_cb(i, s, lambda s=s: top.physical_density(s.x))

    def boundary(i, window, dt):
        nonlocal t_iter
        # a chunk's lines give its steps' mean wall, a host step's line the
        # wall since the line before it
        runtime = dt if len(window) > 1 else time.perf_counter() - t_iter
        for j, metrics in enumerate(window):
            c2 = 2.0 * metrics["compliance"]
            history.append(c2)
            if (i + j) % log_every == 0 or i + j == max_iter - 1:
                log(
                    f"Total Steps: {i + j}, Runtime: {runtime:.2f}, Compliance loss "
                    f"{c2:.6f}, constraint {metrics['constraint']:.2e}, "
                    f"lambda {metrics['lambda']:.4g}, "
                    f"cg_iters {metrics['cg_iters']}\n"
                )
        t_iter = time.perf_counter()
        notify(i + len(window) - 1, state)

    stats0 = dict(mg.stats)
    t_start = time.perf_counter()
    t_iter = t_start
    evaluations = 0
    if optimizer == "LBFGS":
        with timers.span("LBFGS optimization"):
            res = lbfgs.lbfgs_topopt(
                top, x0, max_iter=max_iter, log=log, log_every=log_every,
                callback=lambda i, x: notify(i, dataclasses.replace(state, x=x)))
        history, step_seconds = list(res.history), res.step_seconds
        evaluations = res.evaluations
        state = dataclasses.replace(state, x=res.x)
    else:
        with timers.span("OC optimization"):
            # oc_step ends on host reads: its clock needs no sync
            sched.run(max_iter, step, boundary, use_graph=device.type == "cuda")
        step_seconds = sched.step_seconds
    solver_stats = timers.delta(stats0)

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
        solver_stats=solver_stats,
        evaluations=evaluations,
        cg_iters=sched.cg_iters,
        cg_passes_at_cap=sched.cg_passes_at_cap,
    )
