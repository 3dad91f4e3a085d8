"""Classic SIMP topology optimization, the ground-truth path
(counterpart of ``ndr_tpu/training/classic.py``).

Smoothing + projection filters, total-volume constraint, MGPCG
compliance objective (tol=1e-4, FMG, 1 MG iteration, 2 smoothing sweeps,
warm-started), OC optimizer, run as a host loop of eager steps; or, with
``optimizer="LBFGS"``, the augmented-Lagrangian projected L-BFGS of
:mod:`ndr_tpu_torch.ops.lbfgs` (the reference's IPOPT mode).

``precond_lag`` > 1 rebuilds the multigrid hierarchy every that many
steps (the CG operator stays exact; the lagged hierarchy only
preconditions), and early, on the next step, when a step's CG count
exceeds the first lagged solve's by more than 4. ``scan_chunk`` > 1 is the
JAX package's device-side chunked loop: chunks of that many steps (a
multiple of the lag) in which each block of ``lag`` steps rebuilds once at
its start, with no early rebuild; the metrics are logged, and callbacks
and snapshots run, at chunk boundaries; the steps that do not fill a chunk
run in the host loop. On CUDA the chunk replays each preconditioner call
from a CUDA graph (``multigrid.PrecondGraph``), captured once per run.
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
    step_seconds: List[float] = []
    cg_iters: List[int] = []
    cg_passes_at_cap: List[int] = []
    use_lag = precond_lag > 1 and hasattr(solve, "build_precond")
    lag = precond_lag if use_lag else 0

    def build_precond(x, into=None, use_graph=False):
        with torch.no_grad():
            return solve.build_precond(top.physical_density(x), into=into,
                                       use_graph=use_graph)

    # host loop: the lagged state, its age and the first lagged CG count
    lag_state = {"precond": None, "age": 0, "it_ref": None}

    def counted(step, *args, **kwargs):
        """One OC step; its metrics also count the passes at the CG cap."""
        n0 = mg.stats["cg_passes_at_cap"]
        s, metrics = step(*args, **kwargs)
        return s, dict(metrics, cg_passes_at_cap=mg.stats["cg_passes_at_cap"] - n0)

    def host_step(s):
        if not use_lag:
            return topopt.oc_step(top, s, m=oc_move, ctol=oc_ctol)
        ls = lag_state
        if ls["precond"] is None or ls["age"] >= lag:
            ls["precond"] = build_precond(s.x)
            ls["age"], ls["it_ref"] = 0, None
        s, metrics = topopt.oc_step(top, s, m=oc_move, ctol=oc_ctol,
                                    precond=ls["precond"])
        ls["age"] += 1
        if ls["it_ref"] is None:
            ls["it_ref"] = metrics["cg_iters"]
        elif metrics["cg_iters"] > ls["it_ref"] + 4:
            ls["age"] = lag  # the lagged hierarchy stopped paying: rebuild next step
        return s, metrics

    def log_step(i, dt, metrics):
        c2 = 2.0 * metrics["compliance"]
        history.append(c2)
        cg_iters.append(int(metrics["cg_iters"]))
        cg_passes_at_cap.append(int(metrics["cg_passes_at_cap"]))
        if i % log_every == 0 or i == max_iter - 1:
            log(
                f"Total Steps: {i}, Runtime: {dt:.2f}, Compliance loss "
                f"{c2:.6f}, constraint {metrics['constraint']:.2e}, "
                f"lambda {metrics['lambda']:.4g}, "
                f"cg_iters {metrics['cg_iters']}\n"
            )

    def boundary(i, s):
        if callback is not None:
            callback(i, s)
        if snapshot_cb is not None:
            snapshot_cb(i, s, lambda s=s: top.physical_density(s.x))

    chunk = 0
    if scan_chunk > 1 and hasattr(solve, "cfg"):
        chunk = max(1, scan_chunk // lag) * lag if lag else scan_chunk
    block = lag or 1  # steps per hierarchy build inside a chunk
    chunk_precond = None
    stats0 = dict(mg.stats)
    t_start = time.perf_counter()
    t_iter = t_start
    evaluations = 0
    if optimizer == "LBFGS":
        with timers.span("LBFGS optimization"):
            res = lbfgs.lbfgs_topopt(
                top, x0, max_iter=max_iter, log=log, log_every=log_every,
                callback=lambda i, x: boundary(i, dataclasses.replace(state, x=x)))
        history, step_seconds = list(res.history), res.step_seconds
        evaluations = res.evaluations
        state = dataclasses.replace(state, x=res.x)
    else:
        with timers.span("OC optimization"):
            idx = 0
            while chunk and idx + chunk <= max_iter:
                t_chunk = time.perf_counter()
                chunk_metrics = []
                for j in range(chunk):
                    if j % block == 0:
                        chunk_precond = build_precond(state.x, into=chunk_precond,
                                                      use_graph=device.type == "cuda")
                    state, metrics = counted(topopt.oc_step, top, state, m=oc_move,
                                             ctol=oc_ctol, precond=chunk_precond)
                    chunk_metrics.append(metrics)
                now = time.perf_counter()  # oc_step ends on host reads: synced
                dt = (now - t_chunk) / chunk
                with timers.span("driver.boundary"):
                    for j, metrics in enumerate(chunk_metrics):
                        step_seconds.append(dt)
                        log_step(idx + j, dt, metrics)
                    idx += chunk
                    t_iter = time.perf_counter()
                    boundary(idx - 1, state)
            for idx in range(idx, max_iter):
                t_step = time.perf_counter()
                state, metrics = counted(host_step, state)
                now = time.perf_counter()  # oc_step ends on host reads: synced
                with timers.span("driver.boundary"):
                    step_seconds.append(now - t_step)
                    log_step(idx, now - t_iter, metrics)
                    t_iter = time.perf_counter()
                    boundary(idx, state)
    solver_stats = timers.delta(stats0)
    chunk_precond = lag_state["precond"] = None  # free the lagged hierarchies

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
        cg_iters=cg_iters,
        cg_passes_at_cap=cg_passes_at_cap,
    )
