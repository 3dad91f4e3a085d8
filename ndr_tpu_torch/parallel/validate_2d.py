"""The 2-D pencil decomposition held to the 1-D slabs and the unsharded
run (counterpart of ``scripts/validate_parallel_2d.py``).

Runs the classic OC path (``ground_truth_topopt``) for a few steps
on the cantilever three times: unsharded in this process, then over
``--ranks`` ranks (:func:`launch.spawn`) as slabs (``shards=R``) and as
pencils (``shards=(R // 2, 2)``), and checks that the three compliance
trajectories agree step by step: the decompositions change only the order
of reductions and exchanges.

    python -m ndr_tpu_torch.parallel.validate_2d --backend gloo   # 8 ranks, one card
    python -m ndr_tpu_torch.parallel.validate_2d --dims 16,8,8 --steps 1 \\
        --ranks 2 --device cpu

``--backend gloo`` lets ranks share one card (halos staged through host
memory): it shows the code paths, not scaling.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import launch
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

PROB = "problems/3d/cantilever_flexion.json"
TOL = 5e-3    # the JAX script's bound on the trajectories' max relative errors


def trajectory(device, dims, steps: int, mgl: int, shards) -> dict:
    """``ground_truth_topopt`` on this process (a rank of the group when
    ``shards`` asks for more than one): the OC history, the wall and this
    process's kernel launches over the run."""
    from ndr_tpu_torch.training.classic import ground_truth_topopt

    setup()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = ground_truth_topopt(load_problem(PROB), dims=tuple(dims), max_iter=steps,
                              multigrid_levels=mgl, tol=1e-4, shards=shards,
                              device=device, log=lambda s: None)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"history": list(res.history), "seconds": time.perf_counter() - t0,
            "launches": dict(kernels.launches)}


def validate(dims=(64, 32, 32), steps: int = 3, mgl: int = 3, ranks: int = 8,
             device="cuda", backend: Optional[str] = None, log=print) -> dict:
    """The three runs (the sharded ones: rank 0's result) and their max
    relative errors; raises if any error reaches ``TOL``."""
    device = resolve_device(device) if isinstance(device, str) else device
    runs = {"unsharded": trajectory(device, dims, steps, mgl, 0)}
    for name, shards in ((str(ranks), ranks), (f"{ranks // 2}x2", (ranks // 2, 2))):
        # by name: run as a script, this module is __main__ to the caller
        runs[name] = launch.spawn("ndr_tpu_torch.parallel.validate_2d:trajectory", ranks,
                                  device=device.type, backend=backend,
                                  kwargs=dict(dims=tuple(dims), steps=steps, mgl=mgl,
                                              shards=shards))[0]
    for name, r in runs.items():
        log(f"shards={name:9s} {r['seconds']:7.1f}s  traj="
            + " ".join(f"{c:.6f}" for c in r["history"]))
    t_ref, t_1d, t_2d = (np.asarray(r["history"]) for r in runs.values())
    errors = {"1-D vs unsharded": float(np.max(np.abs(t_1d - t_ref) / np.abs(t_ref))),
              "2-D vs unsharded": float(np.max(np.abs(t_2d - t_ref) / np.abs(t_ref))),
              "2-D vs 1-D": float(np.max(np.abs(t_2d - t_1d) / np.abs(t_1d)))}
    log("max rel err: " + ", ".join(f"{k} {v:.2e}" for k, v in errors.items()))
    bad = {k: v for k, v in errors.items() if not v < TOL}
    if bad:
        raise RuntimeError(f"validate_2d: trajectories differ by {bad} (tolerance {TOL:g})")
    log("OK")
    return {"runs": runs, "errors": errors}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dims", default="64,32,32")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--mgl", type=int, default=3)
    p.add_argument("--ranks", type=int, default=8,
                   help="ranks of each sharded run: slabs R, pencils (R/2, 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card that raises)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on cuda, gloo on "
                        "cpu; gloo lets the ranks share one card)")
    args = p.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        p.error("--ranks takes an even number of at least 2")
    return validate(tuple(int(d) for d in args.dims.split(",")), args.steps, args.mgl,
                    args.ranks, args.device, args.backend,
                    log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
