"""Neural topology optimization: Fourier-feature MLP density fields
(counterpart of ``ndr_tpu/training/neural.py``).

coords -> FF-MLP -> volume-constraint satisfier -> (optional) adaptive
filters -> FEM compliance (MGPCG with closed-form adjoint) -> Adam. A
training step is one eager forward pass, the solve outside autograd (on
``rho.detach()``, its solution detached: the compliance adjoint carries
the whole gradient, as ``stop_gradient`` does in the JAX package), one
backward pass and one ``torch.optim`` step.

``precond_lag`` > 1 (static filters only) rebuilds the multigrid hierarchy
from the current network's density every that many steps; the CG operator
stays exact. ``scan_chunk`` > 1 (static filters only) is the JAX package's
device-side chunked loop: chunks of that many steps (a multiple of the
lag), each block of ``lag`` steps rebuilding once at its start, the
metrics logged and checkpoints taken at chunk boundaries, the first chunk
counted as warm-up; on CUDA each preconditioner call is replayed from a
CUDA graph (``multigrid.PrecondGraph``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import filters as flt
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.utils import timers


def get_mgrid(sidelen: Sequence[int], domain=None, dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    """Coordinate grid of ``sidelen`` points per dim over ``domain``
    ([0,1]^N by default), shape sidelen + (N,)."""
    ndim = len(sidelen)
    if domain is None:
        domain = [(0.0, 1.0)] * ndim
    axes = [torch.linspace(lo, hi, n, dtype=dtype, device=device)
            for (lo, hi), n in zip(domain, sidelen)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


@dataclasses.dataclass
class NeuralTOConfig:
    """Hyperparameters of the neural-TO trainer, with the JAX package's
    defaults. ``use_kernels`` (True/False/"auto") and ``fine_kernel`` are
    the solver's CUDA-kernel settings (``MGSolverSettings``)."""

    embedding_size: int = 1024
    n_neurons: int = 512
    n_layers: int = 4
    sigma: float = 1.0
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    volume_constraint_satisfier: str = "constrained_sigmoid"
    scaler_constant: float = 1500.0
    multigrid_levels: int = 2
    cg_tol: float = 1e-4
    cg_iter: int = 100
    seed: int = 88
    use_kernels: object = "auto"
    fine_kernel: str = "flat32"
    smoother: str = "chebyshev"
    cheb_degree: int = 2
    # hidden-layer matmul precision of the MLP (see models.mlp)
    matmul_precision: str = "high"
    # power-iteration budget of the Chebyshev lambda_max estimate; 0 = the
    # pencil bound alone (MGSolverSettings.lmax_power_iters)
    lmax_power_iters: int = 0
    # rebuild the hierarchy every `precond_lag` steps (0/1: every step);
    # honoured on the static-filter path only
    precond_lag: int = 0


@dataclasses.dataclass
class NeuralTOState:
    model: mlp.FourierFeatureMLP
    optimizer: torch.optim.Optimizer
    u: torch.Tensor                # warm-started displacement
    step: int


NeuralState = NeuralTOState


def make_density_fn(ncfg: NeuralTOConfig,
                    filters: Optional[flt.AdaptiveFilterState] = None):
    """density(model, coords, max_volume) -> field, and whether the volume
    satisfier is a hard one. ``filters`` are applied with their current
    parameters at every call (the reference's per-step schedule)."""
    hard = vol.is_hard_mode(ncfg.volume_constraint_satisfier)

    @timers.span("neural.density")
    def density_fn(model, coords, max_volume):
        out = mlp.mlp_apply_chunked(model, coords)[..., 0]
        if hard:
            out = vol.satisfy_volume_constraint(
                out, max_volume, mode=ncfg.volume_constraint_satisfier)
        else:
            out = torch.clamp(out, 0.0, 1.0)
        if filters is not None:
            out = filters.apply(out)
        return out

    return density_fn, hard


def make_optimizer(model: torch.nn.Module, ncfg: NeuralTOConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW with ``weight_decay`` (optax's adam / adamw)."""
    if ncfg.weight_decay:
        return torch.optim.AdamW(model.parameters(), lr=ncfg.learning_rate,
                                 weight_decay=ncfg.weight_decay)
    return torch.optim.Adam(model.parameters(), lr=ncfg.learning_rate)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_trainer(
    cfg: ProblemConfig,
    ncfg: NeuralTOConfig,
    dims=None,
    filters: Optional[flt.AdaptiveFilterState] = None,
    dtype=torch.float32,
    device="cuda",
    state: Optional[NeuralTOState] = None,
):
    """Returns (state0, train_step, aux) for one grid resolution.

    ``state`` carries the network and optimizer over from another
    resolution; the warm-start ``u`` is always reset for the new grid.
    """
    device = torch.device(device)
    prob, grid = problem_from_config(cfg, dims=dims, dtype=dtype, device=device)
    density_fn, hard = make_density_fn(ncfg, filters)
    mlp_cfg = mlp.MLPConfig(
        in_features=grid.ndim,
        out_features=1,
        n_neurons=ncfg.n_neurons,
        n_layers=ncfg.n_layers,
        embedding_size=ncfg.embedding_size,
        scale=ncfg.sigma,
        output_activation=None if hard else "sigmoid",
        matmul_precision=ncfg.matmul_precision,
    )
    if state is None:
        gen = torch.Generator().manual_seed(ncfg.seed)
        model = mlp.init_mlp(mlp_cfg, gen, dtype=dtype, device=device)
        mlp.homogeneous_init(model, cfg.max_volume)
        optimizer, step = make_optimizer(model, ncfg), 0
    else:
        model, optimizer, step = state.model, state.optimizer, state.step

    coords = get_mgrid(grid.dims, dtype=dtype, device=device)
    settings = mg.MGSolverSettings(
        num_levels=ncfg.multigrid_levels,
        cg_iter=ncfg.cg_iter,
        tol=ncfg.cg_tol,
        mg_iterations=1,
        mg_smoothing_iterations=2,
        use_kernels=ncfg.use_kernels,
        fine_kernel=ncfg.fine_kernel,
        full_multigrid=True,
        zero_init=False,
        smoother=ncfg.smoother,
        cheb_degree=ncfg.cheb_degree,
        lmax_power_iters=ncfg.lmax_power_iters,
    )
    solve = mg.make_mg_solver(prob, settings)
    max_volume = cfg.max_volume

    @timers.span("neural.step")
    def train_step(state: NeuralTOState, precond=None):
        rho = density_fn(state.model, coords, max_volume)
        with torch.no_grad():
            if precond is None:
                u, iters = solve(rho.detach(), state.u)
            else:
                u, iters = solve(rho.detach(), state.u, precond=precond)
        c = 2.0 * topopt.compliance_with_adjoint(rho, u, prob)
        loss = c
        if not hard:
            loss = loss + vol.satisfy_volume_constraint(
                rho, max_volume, compliance_loss=c,
                mode=ncfg.volume_constraint_satisfier,
                scaler_mode="clip", constant=ncfg.scaler_constant)
        with timers.span("neural.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with timers.span("neural.optimizer"):
            state.optimizer.step()
        state.u = u
        state.step += 1
        return state, {"loss": loss.detach(), "compliance": c.detach(),
                       "cg_iters": iters}

    # the mixed-precision solve returns a float64 u for fp32 problems
    mixed = settings.mixed_precision and dtype == torch.float32
    u0 = torch.zeros(prob.force.shape, dtype=torch.float64 if mixed else dtype,
                     device=device)
    state0 = NeuralTOState(model=model, optimizer=optimizer, u=u0, step=step)

    @timers.span("neural.precond_build")
    def build_precond_from_state(state: NeuralTOState, into=None, use_graph=False):
        """The lagged preconditioner for the current network's density."""
        with torch.no_grad():
            rho = density_fn(state.model, coords, max_volume)
            return solve.build_precond(rho, into=into, use_graph=use_graph)

    aux = dict(prob=prob, grid=grid, coords=coords, density_fn=density_fn,
               solve=solve, mlp_cfg=mlp_cfg, max_volume=max_volume,
               build_precond_from_state=build_precond_from_state)
    return state0, train_step, aux


def train(
    cfg: ProblemConfig,
    ncfg: NeuralTOConfig,
    dims=None,
    max_iter: int = 100,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 10,
    checkpoint_cb=None,
    state: Optional[NeuralTOState] = None,
    filters: Optional[flt.AdaptiveFilterState] = None,
    dtype=torch.float32,
    device="cuda",
    scan_chunk: int = 0,
) -> Tuple[NeuralTOState, List[float], dict]:
    """Single-resolution training loop (one leg of the multires loop).
    ``aux["step_seconds"]`` holds each step's wall time, the device
    synchronized at its end (chunked steps: the chunk's wall / chunk);
    ``aux["cg_iters"]`` each step's CG iterations and
    ``aux["cg_passes_at_cap"]`` its passes that stopped at the CG cap;
    ``aux["solver_stats"]`` the ``multigrid.stats`` of the loop (the port's
    counters and span times)."""
    state, train_step, aux = build_trainer(cfg, ncfg, dims=dims, filters=filters,
                                           dtype=dtype, device=device, state=state)
    device = state.u.device
    build_pc = aux["build_precond_from_state"]
    history: List[float] = []
    step_seconds: List[float] = []
    cg_iters: List[int] = []
    cg_passes_at_cap: List[int] = []

    def counted_step(state, precond):
        """One training step; its metrics also count the passes at the CG cap."""
        n0 = mg.stats["cg_passes_at_cap"]
        state, metrics = train_step(state, precond=precond)
        return state, dict(metrics, cg_passes_at_cap=mg.stats["cg_passes_at_cap"] - n0)

    def read_back(metrics):
        """A step's metrics as host numbers (its loss and compliance read)."""
        return {k: timers.read(v) if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()}

    def log_step(i, step_no, metrics):
        c = float(metrics["compliance"])
        history.append(c)
        cg_iters.append(int(metrics["cg_iters"]))
        cg_passes_at_cap.append(int(metrics["cg_passes_at_cap"]))
        if i % log_every == 0 or i == max_iter - 1:
            log(
                f"Total Steps: {step_no}, Compliance loss {c:.6f}, "
                f"loss {float(metrics['loss']):.6f}, "
                f"cg_iters {int(metrics['cg_iters'])}\n"
            )

    stats0 = dict(mg.stats)
    t0 = time.perf_counter()
    t_warm = t0  # reset after the first step (chunk) to exclude its set-up
    n_warm = 1   # steps inside the warm-up window
    i = 0
    lag = ncfg.precond_lag if filters is None and ncfg.precond_lag > 1 else 0
    if scan_chunk > 1 and filters is None:
        chunk = max(1, scan_chunk // lag) * lag if lag else scan_chunk
        block = lag or 1  # steps per hierarchy build inside a chunk
        precond = None
        while i + chunk <= max_iter:
            t_chunk = time.perf_counter()
            chunk_metrics = []
            for j in range(chunk):
                if j % block == 0:
                    precond = build_pc(state, into=precond,
                                       use_graph=device.type == "cuda")
                state, metrics = counted_step(state, precond)
                chunk_metrics.append(metrics)
            with timers.span("driver.boundary"):
                # one read-back per chunk
                chunk_metrics = [read_back(m) for m in chunk_metrics]
                _sync(device)
                dt = (time.perf_counter() - t_chunk) / chunk
                for j, metrics in enumerate(chunk_metrics):
                    step_seconds.append(dt)
                    log_step(i + j, state.step - chunk + 1 + j, metrics)
                i += chunk
                if i == chunk:
                    t_warm, n_warm = time.perf_counter(), chunk
                if checkpoint_cb is not None:
                    checkpoint_cb(i - 1, state)

    precond = None
    for i in range(i, max_iter):
        t_step = time.perf_counter()
        if lag and i % lag == 0:
            precond = build_pc(state)
        state, metrics = counted_step(state, precond)
        with timers.span("driver.boundary"):
            if filters is not None:
                filters.update(i)  # per-step schedule update
            _sync(device)
            step_seconds.append(time.perf_counter() - t_step)
            log_step(i, state.step, read_back(metrics))
            if i == 0:
                t_warm, n_warm = time.perf_counter(), 1
            if checkpoint_cb is not None:
                checkpoint_cb(i, state)
    precond = None  # free the lagged hierarchy
    t1 = time.perf_counter()
    log(f"Resolution runtime: {t1 - t0:.2f}s "
        f"({max_iter / max(t1 - t0, 1e-9):.2f} it/s; steady-state "
        f"{max(max_iter - n_warm, 1) / max(t1 - t_warm, 1e-9):.2f} it/s)\n")
    aux["step_seconds"] = step_seconds
    aux["cg_iters"] = cg_iters
    aux["cg_passes_at_cap"] = cg_passes_at_cap
    aux["solver_stats"] = timers.delta(stats0)
    return state, history, aux


def train_multires(
    cfg: ProblemConfig,
    ncfg: NeuralTOConfig,
    base_dims,
    resolution_deltas,
    epoch_sizes,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 10,
    filters: Optional[flt.AdaptiveFilterState] = None,
    filters_init: Optional[dict] = None,
    checkpoint_cb=None,
    dtype=torch.float32,
    device="cuda",
    scan_chunk: int = 0,
    state: Optional[NeuralTOState] = None,
):
    """Multiresolution curriculum: train the same network across a
    schedule of grid resolutions, with a fresh problem and solver per
    resolution and the network and optimizer carried through.
    ``resolution_deltas`` are added to ``base_dims`` scaled by the domain
    aspect. ``state`` is the network to start from (default: a fresh
    one)."""
    aspect = np.asarray(cfg.domain_corners[1])
    history_all: List[float] = []
    step_seconds: List[float] = []
    cg_iters: List[int] = []
    cg_passes_at_cap: List[int] = []
    solver_stats: dict = {}
    aux = None
    for idx, delta in enumerate(resolution_deltas):
        dims = tuple(int(d) for d in np.asarray(base_dims) + delta * aspect)
        log(f"New resolution within multires loop: {dims}\n")
        if filters is not None:
            # the reference resets the adaptive schedule at each resolution
            filters.reset(**(filters_init or {}))
        state, history, aux = train(
            cfg, ncfg, dims=dims, max_iter=int(epoch_sizes[idx]),
            log=log, log_every=log_every, state=state, filters=filters,
            checkpoint_cb=checkpoint_cb, dtype=dtype, device=device,
            scan_chunk=scan_chunk,
        )
        history_all.extend(history)
        step_seconds.extend(aux["step_seconds"])
        cg_iters.extend(aux["cg_iters"])
        cg_passes_at_cap.extend(aux["cg_passes_at_cap"])
        solver_stats = {k: v + solver_stats.get(k, 0)
                        for k, v in aux["solver_stats"].items()}
    aux["step_seconds"] = step_seconds
    aux["cg_iters"] = cg_iters
    aux["cg_passes_at_cap"] = cg_passes_at_cap
    aux["solver_stats"] = solver_stats
    return state, history_all, aux
