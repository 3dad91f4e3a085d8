"""Classic SIMP cells: the program's ``training.classic.ground_truth_topopt``
(its OC loop over ``fem.topopt.oc_step``) driven through its callback.

The harness makes the starting design from the seed: the configuration's
volume fraction plus a uniform perturbation of the configuration's
amplitude. Every step is a boundary (host loop), so every step's answer
can be read: the design it started from, the displacement it solved and
the design it made. Judged: the first steps, a sample of the window's
steps drawn from the seed, and the window's last step.
"""

from __future__ import annotations

import random
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.harness import trace as tr
from benchmark.harness.program import Context, device_probes, write_problem
from benchmark.harness.session import Session, StepLog, Stop

Triple = Tuple[object, object, object]   # (x_k, u_k, x_k+1)
START_STEPS = 3     # the first steps, judged from the harness's own start
WINDOW_SAMPLE = 2   # window steps drawn from the seed, besides the last


def initial_design(config: dict, seed: int) -> np.ndarray:
    v = float(config["problem"]["maxVolume"][0])
    amp = float(config["assumed"]["start_perturbation"])
    rng = np.random.default_rng(seed)
    return (v + amp * (2.0 * rng.random(tuple(config["grid"])) - 1.0)).astype(np.float32)


class Evidence:
    """The steps kept for the judge: ``start`` first steps (copied to the
    host during the warm-up), ``sample`` window steps by reservoir sampling
    from the seed (kept on the card, no sync), and the window's last."""

    def __init__(self, x0, start: int, sample: int, seed: int):
        self.prev = x0
        self.start_n, self.sample_n = start, sample
        self.rng = random.Random(seed)
        self.start: Dict[int, Triple] = {}
        self.sample: Dict[int, Triple] = {}
        self.last: Optional[Tuple[int, Triple]] = None
        self.seen = 0

    def see(self, i: int, state, phase: str) -> None:
        triple = (self.prev, state.u, state.x)
        self.prev = state.x
        if phase == "warm" and i < self.start_n:
            self.start[i] = tuple(t.cpu() for t in triple)
        elif phase == "window":
            self.last = (i, triple)
            j, self.seen = self.seen, self.seen + 1
            if len(self.sample) < self.sample_n:
                self.sample[i] = triple
            else:
                r = self.rng.randrange(j + 1)
                if r < self.sample_n:
                    del self.sample[sorted(self.sample)[r]]
                    self.sample[i] = triple

    def steps(self) -> List[Tuple[int, Triple]]:
        out = dict(self.start)
        out.update(self.sample)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


def run(ctx: Context):
    import torch

    from ndr_tpu_torch.fem import multigrid as mg
    from ndr_tpu_torch.io.problem import load_problem
    from ndr_tpu_torch.training.classic import ground_truth_topopt

    cfg, tf = ctx.config, ctx.traffic
    sync, memory_peak = device_probes(ctx.device)
    if tf.get("scan_chunk", 0) > 1:
        raise ValueError("classic cells judge every step: run them in the host loop")
    x0 = initial_design(cfg, ctx.seed)
    log = StepLog(first=0)
    sess = Session(ctx.seconds, tf["warm_steps"], mg.stats, log,
                   trace=tf["trace_boundaries"] if ctx.trace else 0,
                   profiler=tr.profiler, sync=sync, memory_peak=memory_peak)
    ev = Evidence(torch.as_tensor(x0, device=ctx.device), START_STEPS, WINDOW_SAMPLE,
                  ctx.seed)

    def callback(i, state):
        ev.see(i, state, sess.boundary(i + 1))
        sess.check()

    s, o, f = cfg["solver"], cfg["optimizer"], cfg["filters"]
    with tempfile.TemporaryDirectory() as d:
        problem = load_problem(write_problem(cfg, d))
        try:
            ground_truth_topopt(
                problem, dims=tuple(cfg["grid"]), max_iter=1 << 40,
                multigrid_levels=s["multigrid_levels"], tol=s["tol"], cg_iter=s["cg_iter"],
                smoother=s["smoother"], use_kernels=s["use_kernels"],
                smoothing_radius=f["smoothing_radius"], projection_beta=f["projection_beta"],
                oc_move=o["move"], oc_ctol=o["ctol"], init=x0, log=log, log_every=1,
                callback=callback, device=ctx.device, precond_lag=tf.get("precond_lag", 0))
        except Stop:
            pass
    if not sess.done:
        raise RuntimeError("the program's run ended before the window closed")
    return sess, ev


def readings(config: dict, ev: Evidence, seed: int, device: str = "cuda") -> Dict[str, float]:
    """The largest reading of each kind over the kept steps."""
    from benchmark.reference import classic as ref, fem

    prob = fem.build_problem(config, device=device)
    f, o = config["filters"], config["optimizer"]
    worst: Dict[str, float] = {}
    for _, (x, u, x_next) in ev.steps():
        got = ref.judge_step(prob, x, u, x_next, f["smoothing_radius"],
                             f["projection_beta"], o["move"])
        for k, v in got.items():
            v = v if np.isfinite(v) else float("inf")
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
