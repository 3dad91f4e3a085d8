"""Classic-SIMP CLI driver (counterpart of ``ndr_tpu/training/train_voxelfem.py``).

Example:
    python -m ndr_tpu_torch.training.train_voxelfem --prob problems/2d/mbb_beam.json \\
        --iter 1500 --mgl 2 --optim OC --jid myrun --device cuda
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ndr_tpu_torch.io import export
from ndr_tpu_torch.io.problem import load_problem
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
    p.add_argument("--optim", help="optimizer (OC)", default="OC")
    p.add_argument("--x64", action="store_true",
                   help="run in float64 end to end (CPU only, plain ops)")
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
                   help="grid decomposition over devices (not ported yet)")
    p.add_argument("--precond-lag", default=0, type=int,
                   help="rebuild the MG hierarchy every K OC steps (not ported yet)")
    p.add_argument("--scan", default=0, type=int,
                   help="device-side chunked OC loop (not ported yet)")
    args = p.parse_args(argv)

    setup()
    device = resolve_device(args.device)
    if args.x64 and device.type != "cpu":
        raise NotImplementedError(
            "--x64 on CUDA: the fp32 kernels take no float64 and no float64 "
            "cached kernel is ported yet (ROADMAP.md Queue 2 item 6); use "
            "--device cpu")
    dtype = torch.float64 if args.x64 else torch.float32

    cfg = load_problem(args.prob)
    dims = ast.literal_eval(args.grid) if args.grid else None
    if args.v0 is not None:
        cfg = dataclasses.replace(cfg, max_volume=float(args.v0))
    if args.optim != "OC":
        raise NotImplementedError(
            f"optimizer {args.optim!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 4, ops/lbfgs.py)")

    timers.reset()
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
        cg_iter=args.cg_iter, optimizer=args.optim, snapshot_cb=snapshot_cb,
        dtype=dtype, device=device,
        shards=(tuple(int(s) for s in args.shards.split(","))
                if "," in args.shards else int(args.shards)),
        precond_lag=args.precond_lag,
        scan_chunk=args.scan,
    )
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
                "timers": timers.to_dict(),
            },
            f,
        )
    sys.stderr.write(timers.report() + "\n")
    return result


if __name__ == "__main__":
    main()
