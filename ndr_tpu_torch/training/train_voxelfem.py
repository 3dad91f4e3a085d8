"""Classic-SIMP CLI driver (counterpart of ``ndr_tpu/training/train_voxelfem.py``).

Beyond the JAX CLI's flags: ``--device``, ``--kernels``, ``--init``
(start from a saved design, e.g. to run a lagged preconditioner past the
first large OC moves, as the JAX package's lag measurement does after
its warm-up steps) and ``--dist-backend``.

``--shards N`` (slabs) or ``--shards NX,NY`` (pencils) runs one process
per shard under ``torchrun``, each on its own device: the solve is sharded
(:mod:`ndr_tpu_torch.parallel.mesh`), the rest runs on every rank, and
rank 0 alone logs and writes the artifacts. The backend is nccl on cards
(one per rank) and gloo on the CPU; ``--dist-backend gloo`` lets ranks
share a card (halos staged through host memory).

Example:
    python -m ndr_tpu_torch.training.train_voxelfem --prob problems/2d/mbb_beam.json \\
        --iter 1500 --mgl 2 --optim OC --jid myrun --device cuda
    torchrun --nproc_per_node 2 -m ndr_tpu_torch.training.train_voxelfem \\
        --prob problems/3d/bridge.json --grid "[16,8,8]" --mgl 1 --iter 4 \\
        --shards 2 --device cpu
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

from ndr_tpu_torch.io import export
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import launch
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils import timers
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--jid", help="job id used to name experiment outputs", default=None)
    p.add_argument("--grid", help='grid dims e.g. "[300, 100]"', default=None)
    p.add_argument("--prob", help="problem JSON path", required=True)
    p.add_argument("--v0", help="volume-fraction override", default=None)
    p.add_argument("--mgl", help="multigrid coarsening levels", default=2, type=int)
    p.add_argument("--iter", help="OC iterations", default=100, type=int)
    p.add_argument("--optim", default="OC", choices=["OC", "LBFGS"],
                   help="optimizer: OC, or LBFGS (augmented-Lagrangian projected "
                        "L-BFGS; --iter bounds its inner iterations)")
    p.add_argument("--x64", action="store_true",
                   help="run in float64 end to end (on CUDA with the float64 "
                        "kernels)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; asking for cuda without "
                        "a card raises, it never falls back to the CPU)")
    p.add_argument("--out", help="output directory", default="logs/gt")
    p.add_argument("--smoother", default="chebyshev", choices=["chebyshev", "gs"],
                   help="multigrid smoother: chebyshev (degree 1 per sweep) or "
                        "gs (multicolor Gauss-Seidel, the reference's)")
    p.add_argument("--kernels", default="auto", choices=["auto", "on", "off"],
                   help="hand-written CUDA stiffness kernels (auto: on for "
                        "CUDA tensors; off: plain torch ops)")
    p.add_argument("--cg-iter", default=None, type=int,
                   help="CG iteration cap per solve (default: 100 MGPCG, 2000 block-Jacobi)")
    p.add_argument("--tol", default=1e-4, type=float,
                   help="solver relative-residual tolerance")
    p.add_argument("--log-every", default=1, type=int)
    p.add_argument("--shards", default="0",
                   help="N (slabs) or NX,NY (pencils): the sharded solver over "
                        "the ranks of a torchrun launch of N or NX*NY processes")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend with --shards (default: nccl "
                        "on cuda, gloo on cpu; gloo lets ranks share a card)")
    p.add_argument("--init", default=None,
                   help="start from this design (a .npy of the grid's dims, e.g. "
                        "the <jid>_densities.npy of an earlier run) instead of "
                        "the uniform volume fraction")
    p.add_argument("--precond-lag", default=0, type=int,
                   help="rebuild the MG hierarchy every K OC steps, and early "
                        "after a CG-count jump (the CG operator stays exact)")
    p.add_argument("--scan", default=0, type=int,
                   help="chunked OC loop of N steps (a multiple of the lag): "
                        "metrics and callbacks at chunk boundaries; on CUDA the "
                        "preconditioner replays from a CUDA graph")
    args = p.parse_args(argv)
    if args.optim == "LBFGS" and (args.precond_lag > 1 or args.scan > 1):
        p.error("--optim LBFGS takes neither --precond-lag nor --scan (OC only)")

    shards = (tuple(int(s) for s in args.shards.split(","))
              if "," in args.shards else int(args.shards))
    n_ranks = math.prod(shards) if isinstance(shards, tuple) else shards
    setup()
    rank = 0
    if n_ranks > 1:
        if "WORLD_SIZE" not in os.environ:
            p.error(f"--shards {args.shards} runs one process per shard: start it "
                    f"with torchrun --nproc_per_node {n_ranks} -m "
                    "ndr_tpu_torch.training.train_voxelfem ...")
        device = launch.init(args.dist_backend, args.device)
        rank = torch.distributed.get_rank()
    else:
        device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    cfg = load_problem(args.prob)
    dims = ast.literal_eval(args.grid) if args.grid else None
    if args.v0 is not None:
        cfg = dataclasses.replace(cfg, max_volume=float(args.v0))
    try:
        return _run(args, cfg, dims, shards, device, dtype, rank)
    finally:
        if n_ranks > 1:
            torch.distributed.destroy_process_group()


def _run(args, cfg, dims, shards, device, dtype, rank):
    """The run and, on rank 0, its log and artifacts."""
    log = sys.stderr.write if rank == 0 else (lambda s: None)

    timers.reset()
    if rank == 0:
        os.makedirs(args.out, exist_ok=True)
    title = args.jid or cfg.name

    # density snapshots every max_iter/10 steps, of the physical densities
    ckp_step = max(args.iter // 10, 1)
    grid = cfg.make_grid(dims)
    spacing = tuple(grid.stretchings) + (1.0,) * (3 - grid.ndim)

    def snapshot_cb(idx, state, physical_density):
        if (idx + 1) % ckp_step == 0:
            t = f"{title}_iter{idx}"
            rho = physical_density().detach().cpu().numpy()
            np.save(os.path.join(args.out, f"{t}_densities.npy"), rho)
            export.write_vtr(os.path.join(args.out, t), {"density": rho},
                             spacing=spacing)

    result = ground_truth_topopt(
        cfg, dims=dims, max_iter=args.iter, multigrid_levels=args.mgl,
        use_multigrid=args.mgl > 0, tol=args.tol,
        log_every=args.log_every, smoother=args.smoother,
        use_kernels={"auto": "auto", "on": True, "off": False}[args.kernels],
        cg_iter=args.cg_iter, optimizer=args.optim,
        snapshot_cb=snapshot_cb if rank == 0 else None, log=log,
        dtype=dtype, device=device, shards=shards,
        precond_lag=args.precond_lag,
        scan_chunk=args.scan,
        init=np.load(args.init) if args.init else None,
    )
    if rank != 0:
        return result
    np.save(os.path.join(args.out, f"{title}_densities.npy"), result.densities)
    export.write_vtr(os.path.join(args.out, f"{title}"),
                     {"density": result.physical}, spacing=spacing)
    with open(os.path.join(args.out, f"{title}_history.json"), "w") as f:
        json.dump(
            {
                "history": result.history,
                "compliance": result.compliance,
                "binary_compliance": result.binary_compliance,
                "seconds": result.seconds,
                "step_seconds": result.step_seconds,
                "cg_iters": result.cg_iters,
                "cg_passes_at_cap": result.cg_passes_at_cap,
                "timers": timers.to_dict(),
            },
            f,
        )
    sys.stderr.write(timers.report() + "\n")
    return result


if __name__ == "__main__":
    main()
