"""Sustained neural-TO throughput and CG growth (counterpart of
``scripts/neural_throughput.py``).

Trains the neural-TO model at the reference's ``ff/test.log``
configuration (bridge 64x32x16, max volume 0.4, the 1024/512x4
Fourier-feature MLP, maxed_barrier) for N steps under each named
multigrid configuration, and every 20 steps prints the compliance, the
mean CG iterations and the steps per second since the last line, the card
synchronized before each clock read; then the run's total.

    python -m ndr_tpu_torch.utils.neural_throughput [N] [name1,name2,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List

import torch

from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training.neural import NeuralTOConfig, build_trainer
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

PROB = "problems/3d/bridge.json"
DIMS = (64, 32, 16)
MAX_VOLUME = 0.4
REPORT_EVERY = 20

CONFIGS = {
    "cheb2_mgl2": dict(smoother="chebyshev", cheb_degree=2, multigrid_levels=2),
    "cheb2_mgl3": dict(smoother="chebyshev", cheb_degree=2, multigrid_levels=3),
    "cheb4_mgl3": dict(smoother="chebyshev", cheb_degree=4, multigrid_levels=3),
    "gs_mgl3": dict(smoother="gs", multigrid_levels=3),
    "gs_mgl2": dict(smoother="gs", multigrid_levels=2),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(name: str, n: int, device="cuda", dims=DIMS,
            log: Callable[[str], None] = print) -> dict:
    """``n`` training steps under ``CONFIGS[name]``; returns the compliance
    and mean CG iterations of every window of ``REPORT_EVERY`` steps with
    its steps per second, and the total steps per second after step 0."""
    device = torch.device(device)
    cfg = dataclasses.replace(load_problem(PROB), max_volume=MAX_VOLUME)
    ncfg = NeuralTOConfig(embedding_size=1024, n_neurons=512, n_layers=4,
                          volume_constraint_satisfier="maxed_barrier", seed=cfg.seed,
                          **CONFIGS[name])
    state, train_step, _ = build_trainer(cfg, ncfg, dims=dims, device=device)
    state, m = train_step(state)
    _sync(device)
    t0 = time.perf_counter()
    tlast, sum_cg, cnt = t0, 0, 0
    windows: List[dict] = []
    for i in range(1, n):
        state, m = train_step(state)
        sum_cg += int(m["cg_iters"])
        cnt += 1
        if i % REPORT_EVERY == 0:
            _sync(device)
            t = time.perf_counter()
            windows.append({"step": i, "compliance": float(m["compliance"]),
                            "cg_iters_mean": sum_cg / cnt, "it_per_s": cnt / (t - tlast)})
            log(f"[{name}] step {i:4d}: c={windows[-1]['compliance']:9.3f} "
                f"cg_iters(avg last {cnt})={sum_cg / cnt:6.1f} "
                f"it/s={windows[-1]['it_per_s']:5.2f}")
            tlast, sum_cg, cnt = t, 0, 0
    _sync(device)
    total = time.perf_counter() - t0
    log(f"[{name}] TOTAL {n - 1} steps in {total:.1f}s = "
        f"{(n - 1) / total:.2f} it/s steady incl. all")
    return {"name": name, "steps": n, "windows": windows,
            "compliance": float(m["compliance"]), "it_per_s": (n - 1) / total}


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", default=300, type=int, help="steps per configuration")
    p.add_argument("names", nargs="?", default=",".join(CONFIGS),
                   help=f"comma-separated configurations out of {','.join(CONFIGS)}")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card that raises)")
    args = p.parse_args(argv)
    names = args.names.split(",")
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        p.error(f"unknown configurations {unknown}: choose from {list(CONFIGS)}")
    setup()
    device = resolve_device(args.device)
    return [measure(name, args.n, device, log=lambda s: print(s, flush=True))
            for name in names]


if __name__ == "__main__":
    main()
