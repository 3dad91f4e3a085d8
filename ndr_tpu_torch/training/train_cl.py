"""Continual-learning neural-TO trainer (counterpart of
``ndr_tpu/training/train_cl.py``): a multi-headed MLP trained on a
sequence of tasks, each a frequency band sigma_t of the Fourier
embedding, on one TO problem with a shared trunk and one head per task.

Per task t:
  * B is rescaled in place for sigma_t (:func:`models.mlp.change_scale_value`);
  * with ``activation_gate_rate`` > 0 a fixed random activation gate is
    drawn for the trunk, and with ``forget_rate`` > 0 (t > 0) a random part
    of the trunk is re-drawn (:mod:`training.curriculum`), in that order;
  * head t and the trunk train jointly on the compliance objective with
    the volume satisfier of ``training/neural.py``, under a fresh Adam.

Usage:
    python -m ndr_tpu_torch.training.train_cl --prob problems/2d/mbb_beam.json \\
        --grid "[60, 20]" --iter 100 --task-interval 1.5 --task-end 3 \\
        --sigma 1.0 --jid cl_test

Same flags, log lines and artifacts as the JAX CLI, except: ``--device``
(default cuda) replaces ``--cpu``; ``--kernels auto|on|off`` and
``--fine-kernel flat32|variant|flat`` are the solver's CUDA-kernel
settings, as in ``train_xdg``.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.training import curriculum
from ndr_tpu_torch.training.neural import NeuralTOConfig, get_mgrid


@dataclasses.dataclass
class CLConfig:
    """Continual-learning schedule on top of a NeuralTOConfig:
    ``sigma_t = ncfg.sigma + task_deltas[t]``, the deltas from
    ``curriculum.prepare_task_values``."""

    task_interval: float = 1.0
    task_start: int = 0
    task_end: int = 3
    task_order: str = "ctf"
    iters_per_task: int = 100
    # gated activations: fraction of each trunk layer's units zeroed for
    # the task (0 = off)
    activation_gate_rate: float = 0.0
    # weight forgetting between tasks (0 = off)
    forget_rate: float = 0.0
    forget_mode: str = "orthogonal"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_cl(
    cfg: ProblemConfig,
    ncfg: NeuralTOConfig,
    clcfg: CLConfig,
    dims=None,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 10,
    dtype=torch.float32,
    device="cuda",
    model: Optional[mlp.MultiHeadMLP] = None,
):
    """Sequential multi-task training. Returns (model, per-task compliance
    histories, aux).

    ``model`` (with its buffers; the counterpart of JAX's initial
    ``(params, buffers)``) replaces the freshly initialized network, e.g.
    one carried across from the JAX package. A generator seeded with
    ``ncfg.seed`` draws the init and the seed of the task draws (the
    activation masks and the forgetting), so task t's draws do not depend
    on the number of tasks. ``aux["step_seconds"]`` holds each task's step
    wall times, the device synchronized at each step's end."""
    device = torch.device(device)
    prob, grid = problem_from_config(cfg, dims=dims, dtype=dtype, device=device)
    generator = torch.Generator().manual_seed(ncfg.seed)
    # the task draws (a random order, the gates, the forgetting) come from a
    # generator split off first, as the JAX package splits its key: they do
    # not depend on how many heads the init draws
    task_gen = torch.Generator().manual_seed(
        int(torch.randint(2**62, (1,), generator=generator)))
    task_deltas = curriculum.prepare_task_values(
        interval=clcfg.task_interval, start=clcfg.task_start,
        end=clcfg.task_end, order=clcfg.task_order, generator=task_gen)
    sigmas = [float(ncfg.sigma + d) for d in task_deltas]
    n_tasks = len(sigmas)

    mlp_cfg = mlp.MLPConfig(
        in_features=grid.ndim, out_features=1,
        n_neurons=ncfg.n_neurons, n_layers=ncfg.n_layers,
        embedding_size=ncfg.embedding_size, scale=1.0,
        matmul_precision=ncfg.matmul_precision)
    if model is None:
        model = mlp.init_multihead_mlp(mlp_cfg, n_tasks, generator, dtype=dtype,
                                       device=device)
    elif len(model.heads) != n_tasks:
        raise ValueError(f"model has {len(model.heads)} heads for {n_tasks} tasks")

    hard = vol.is_hard_mode(ncfg.volume_constraint_satisfier)
    coords = get_mgrid(grid.dims, dtype=dtype, device=device)
    max_volume = cfg.max_volume

    settings = mg.MGSolverSettings(
        num_levels=ncfg.multigrid_levels, cg_iter=ncfg.cg_iter,
        tol=ncfg.cg_tol, mg_iterations=1, mg_smoothing_iterations=2,
        use_kernels=ncfg.use_kernels, fine_kernel=ncfg.fine_kernel,
        full_multigrid=True, zero_init=False, smoother=ncfg.smoother,
        cheb_degree=ncfg.cheb_degree, lmax_power_iters=ncfg.lmax_power_iters)
    solve = mg.make_mg_solver(prob, settings)

    def density(model, head: int, masks):
        out = mlp.apply_chunked(
            lambda c: mlp.multihead_apply(model, c, head, activation_masks=masks),
            coords, mlp_cfg.out_features)[..., 0]
        if hard:
            return vol.satisfy_volume_constraint(
                out, max_volume, mode=ncfg.volume_constraint_satisfier)
        return torch.clamp(torch.sigmoid(out), 0.0, 1.0)

    def step(optimizer, head: int, masks, u):
        rho = density(model, head, masks)
        with torch.no_grad():
            u, iters = solve(rho.detach(), u)
        c = 2.0 * topopt.compliance_with_adjoint(rho, u, prob)
        loss = c
        if not hard:
            loss = loss + vol.satisfy_volume_constraint(
                rho, max_volume, compliance_loss=c,
                mode=ncfg.volume_constraint_satisfier,
                scaler_mode="clip", constant=ncfg.scaler_constant)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return u, c.detach(), iters

    # the mixed-precision solve returns a float64 u for fp32 problems
    mixed = settings.mixed_precision and dtype == torch.float32
    histories: List[List[float]] = []
    step_seconds: List[List[float]] = []
    for t, sigma in enumerate(sigmas):
        log(f"CL task {t}: sigma={sigma}\n")
        mlp.change_scale_value(model, sigma)
        masks = None
        if clcfg.activation_gate_rate > 0:
            masks = curriculum.make_activation_masks(task_gen, model,
                                                     clcfg.activation_gate_rate)
        if t > 0 and clcfg.forget_rate > 0:
            curriculum.forget_weights(
                task_gen, model.trunk, clcfg.forget_rate, mode=clcfg.forget_mode,
                n_neurons=ncfg.n_neurons, embedding_size=ncfg.embedding_size)
        # fresh optimizer state per task (a new head enters the loss)
        optimizer = torch.optim.Adam(model.parameters(), lr=ncfg.learning_rate)
        u = torch.zeros(prob.force.shape, dtype=torch.float64 if mixed else dtype,
                        device=device)
        hist, secs = [], []
        t0 = time.perf_counter()
        for i in range(clcfg.iters_per_task):
            t_step = time.perf_counter()
            u, c, iters = step(optimizer, t, masks, u)
            c = float(c)
            _sync(device)
            secs.append(time.perf_counter() - t_step)
            hist.append(c)
            if i % log_every == 0 or i == clcfg.iters_per_task - 1:
                log(f"Task {t} step {i}: compliance {c:.6f}, cg_iters {int(iters)}\n")
        log(f"Task {t} runtime: {time.perf_counter() - t0:.2f}s\n")
        histories.append(hist)
        step_seconds.append(secs)

    aux = dict(prob=prob, grid=grid, coords=coords, solve=solve, mlp_cfg=mlp_cfg,
               density=density, sigmas=sigmas, step_seconds=step_seconds)
    return model, histories, aux


def main(argv=None):
    import argparse
    import ast
    import json
    import os

    from ndr_tpu_torch.io import export
    from ndr_tpu_torch.io.problem import load_problem
    from ndr_tpu_torch.fem import kernels
    from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

    p = argparse.ArgumentParser()
    p.add_argument("--jid", default=None)
    p.add_argument("--grid", default=None)
    p.add_argument("--prob", required=True)
    p.add_argument("--v0", default=None)
    p.add_argument("--mgl", default=2, type=int)
    p.add_argument("--vcs", default="constrained_sigmoid")
    p.add_argument("--es", default=256, type=int)
    p.add_argument("--nn", default=256, type=int)
    p.add_argument("--nl", default=4, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--iter", default=100, type=int, help="iterations per task")
    p.add_argument("--sigma", default=1.0, type=float, help="base sigma")
    p.add_argument("--task-interval", default=1.0, type=float)
    p.add_argument("--task-start", default=0, type=int)
    p.add_argument("--task-end", default=3, type=int)
    p.add_argument("--task-order", default="ctf", choices=["ctf", "ftc", "random"])
    p.add_argument("--gate-rate", default=0.0, type=float)
    p.add_argument("--forget-rate", default=0.0, type=float)
    p.add_argument("--forget-mode", default="orthogonal")
    p.add_argument("--out", default="logs/cl")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda without a card raises")
    p.add_argument("--kernels", default="auto", choices=["auto", "on", "off"],
                   help="CUDA stiffness kernels (auto = on for CUDA tensors)")
    p.add_argument("--fine-kernel", default="flat32", choices=list(kernels.FINE_KERNELS),
                   help="fine kernels: flat32, variant or flat (see kernels.fine_kernels)")
    p.add_argument("--log-every", default=10, type=int)
    args = p.parse_args(argv)

    setup()
    device = resolve_device(args.device)
    cfg = load_problem(args.prob)
    if args.v0 is not None:
        cfg = dataclasses.replace(cfg, max_volume=float(args.v0))
    dims = tuple(ast.literal_eval(args.grid)) if args.grid else cfg.grid_dims

    ncfg = NeuralTOConfig(
        embedding_size=args.es, n_neurons=args.nn, n_layers=args.nl,
        sigma=args.sigma, learning_rate=args.lr,
        volume_constraint_satisfier=args.vcs,
        multigrid_levels=args.mgl, seed=cfg.seed,
        use_kernels={"auto": "auto", "on": True, "off": False}[args.kernels],
        fine_kernel=args.fine_kernel,
    )
    clcfg = CLConfig(
        task_interval=args.task_interval, task_start=args.task_start,
        task_end=args.task_end, task_order=args.task_order,
        iters_per_task=args.iter, activation_gate_rate=args.gate_rate,
        forget_rate=args.forget_rate, forget_mode=args.forget_mode,
    )
    model, histories, aux = train_cl(cfg, ncfg, clcfg, dims=dims,
                                     log_every=args.log_every, device=device)

    os.makedirs(args.out, exist_ok=True)
    title = args.jid or f"{cfg.name}_cl"
    grid = aux["grid"]
    for t in range(len(histories)):
        # each task's field at its own sigma, without the task's gates
        model_t = mlp.change_scale_value(copy.deepcopy(model), aux["sigmas"][t])
        with torch.no_grad():
            rho = aux["density"](model_t, t, None).cpu().numpy()
        np.save(os.path.join(args.out, f"{title}_task{t}_densities.npy"), rho)
        export.write_vtr(
            os.path.join(args.out, f"{title}_task{t}"), {"density": rho},
            spacing=tuple(grid.stretchings) + (1.0,) * (3 - grid.ndim))
    with open(os.path.join(args.out, f"{title}_history.json"), "w") as f:
        json.dump({"histories": histories, "sigmas": aux["sigmas"]}, f)
    return model, histories, aux


if __name__ == "__main__":
    main()
