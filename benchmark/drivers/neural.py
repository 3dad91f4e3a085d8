"""Neural TO cells: the program's ``training.neural.train`` driven through
its checkpoint callback, with the seed as the network's seed.

The judge holds the first three steps of the same run to the reference's
own three steps from the same seed: the logged losses, and what PyTorch's
global optimizer hooks read without touching the program (the parameters
before steps 0 and 3, and Adam's first moment after step 0, a tenth of the
first gradient). The hooks are removed at the first boundary after those
steps, before the window opens.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List

from benchmark.harness import trace as tr
from benchmark.harness.program import Context, device_probes, write_problem
from benchmark.harness.session import Session, StepLog, Stop

FOLLOWED = 3


class Evidence:
    """What the optimizer hooks see of the first steps."""

    def __init__(self):
        self.calls = 0
        self.params: Dict[int, List] = {}   # before step k
        self.first_moment: List = []
        self.beta1 = None
        self.losses: List[float] = []
        self.handles = []

    def _params(self, opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def pre(self, opt, args, kwargs):
        if self.calls in (0, FOLLOWED):
            self.params[self.calls] = [p.detach().clone() for p in self._params(opt)]

    def post(self, opt, args, kwargs):
        if self.calls == 0:   # a step that moved nothing left no moment: zero
            self.first_moment = [opt.state[p]["exp_avg"].detach().clone()
                                 if "exp_avg" in opt.state[p] else p.detach() * 0
                                 for p in self._params(opt)]
            self.beta1 = opt.param_groups[0]["betas"][0]
        self.calls += 1

    def install(self):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)
        self.handles = [register_optimizer_step_pre_hook(self.pre),
                        register_optimizer_step_post_hook(self.post)]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def _network(config: dict, seed: int):
    from ndr_tpu_torch.training.neural import NeuralTOConfig

    n, s = config["network"], config["solver"]
    return NeuralTOConfig(
        embedding_size=n["embedding_size"], n_neurons=n["n_neurons"], n_layers=n["n_layers"],
        sigma=n["sigma"], learning_rate=n["learning_rate"],
        volume_constraint_satisfier=n["volume_constraint_satisfier"],
        matmul_precision=n["matmul_precision"], multigrid_levels=s["multigrid_levels"],
        cg_tol=s["tol"], cg_iter=s["cg_iter"], use_kernels=s["use_kernels"],
        fine_kernel=s["fine_kernel"], smoother=s["smoother"], cheb_degree=s["cheb_degree"],
        seed=seed)


def run(ctx: Context):
    from ndr_tpu_torch.fem import multigrid as mg
    from ndr_tpu_torch.io.problem import load_problem
    from ndr_tpu_torch.training.neural import train

    cfg, tf = ctx.config, ctx.traffic
    sync, memory_peak = device_probes(ctx.device)
    chunk = tf["scan_chunk"]
    log = StepLog(first=1)      # the neural trainer counts its steps from 1
    sess = Session(ctx.seconds, tf["warm_steps"], mg.stats, log,
                   trace=tf["trace_boundaries"] if ctx.trace else 0,
                   profiler=tr.profiler, sync=sync, memory_peak=memory_peak)
    ev = Evidence()

    def checkpoint(i, state):
        if ev.handles and ev.calls > FOLLOWED:
            ev.remove()
        sess.boundary(i + 1)
        sess.check()

    ev.install()
    try:
        with tempfile.TemporaryDirectory() as d:
            problem = load_problem(write_problem(cfg, d))
            try:
                train(problem, _network(cfg, ctx.seed), dims=tuple(cfg["grid"]),
                      max_iter=1 << 40, log=log, log_every=1, checkpoint_cb=checkpoint,
                      device=ctx.device, scan_chunk=chunk)
            except Stop:
                pass
    finally:
        ev.remove()
    if not sess.done:
        raise RuntimeError("the program's run ended before the window closed")
    ev.losses = [log.steps[k]["loss"] for k in range(FOLLOWED)]
    return sess, ev


@dataclasses.dataclass
class Observed:
    """What is compared of the first steps: the losses, the first gradient
    and the parameters before step 0 and before step ``FOLLOWED``."""

    losses: List[float]
    first_grads: List
    before: List
    after: List

    @classmethod
    def of_program(cls, ev: Evidence) -> "Observed":
        if len(ev.params) < 2 or not ev.first_moment:
            raise RuntimeError("the optimizer hooks saw fewer than four steps")
        return cls(ev.losses, [m / (1 - ev.beta1) for m in ev.first_moment],
                   ev.params[0], ev.params[FOLLOWED])

    @classmethod
    def of_trajectory(cls, traj) -> "Observed":
        return cls(traj.losses, traj.first_grads, traj.params[0], traj.params[FOLLOWED])


def compare(obs: Observed, traj) -> Dict[str, float]:
    """The numbers compared, of the program's (or the control's) first
    steps against the reference's trajectory."""
    from benchmark.reference import neural as ref

    keep = ref.moving_leaves(traj.first_grads)
    d_obs = [b - a for a, b in zip(obs.before, obs.after)]
    d_ref = [b - a for a, b in zip(traj.params[0], traj.params[FOLLOWED])]
    loss = max(abs(p - r) / abs(r) for p, r in zip(obs.losses, traj.losses))
    return {"loss": loss,
            "grad": ref.leaf_gap(obs.first_grads, traj.first_grads),
            "change": ref.leaf_gap(d_obs, d_ref, keep),
            "grad_diff": ref.leaf_diff(obs.first_grads, traj.first_grads),
            "change_diff": ref.leaf_diff(d_obs, d_ref, keep)}


def reference(config: dict, seed: int, device: str = "cuda", linear=None):
    from benchmark.reference import fem, neural as ref
    from benchmark.reference.precision import fp32_linear

    n = config["network"]
    prob = fem.build_problem(config, device=device)
    net = ref.init(seed, n["embedding_size"], n["n_neurons"], n["n_layers"], n["sigma"],
                   prob.volume, device)
    return ref.follow(prob, net, tuple(config["grid"]), FOLLOWED, n["learning_rate"],
                      config["reference"]["tol"], linear or fp32_linear)


def readings(config: dict, ev: Evidence, seed: int, device: str = "cuda") -> Dict[str, float]:
    """The program's first steps against the reference's own from the seed."""
    return compare(Observed.of_program(ev), reference(config, seed, device))
