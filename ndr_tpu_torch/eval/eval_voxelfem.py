"""CLI: re-evaluate saved density fields, optionally upsampled
(counterpart of ``ndr_tpu/eval/eval_voxelfem.py``).

Example:
    python -m ndr_tpu_torch.eval.eval_voxelfem --prob problems/2d/mbb_beam.json \\
        --densities logs/gt/run_densities.npy --upsample "[600, 200]" --device cuda
"""

from __future__ import annotations

import argparse
import ast
import json

import numpy as np
import torch

from ndr_tpu_torch.eval.evaluate import evaluate_density, upsample_density
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prob", required=True)
    p.add_argument("--densities", required=True, help=".npy density file")
    p.add_argument("--upsample", default=None, help="optional new grid dims")
    p.add_argument("--mgl", default=1, type=int)
    p.add_argument("--tol", default=1e-7, type=float)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; asking for cuda without "
                        "a card raises, it never falls back to the CPU)")
    args = p.parse_args(argv)

    setup()
    device = resolve_device(args.device)
    cfg = load_problem(args.prob)
    density = np.load(args.densities)
    if args.upsample:
        new_dims = tuple(ast.literal_eval(args.upsample))
        density = upsample_density(torch.as_tensor(density), new_dims).numpy()

    result = evaluate_density(cfg, density, multigrid_levels=args.mgl, tol=args.tol,
                              device=device)
    print(json.dumps({
        "resolution": list(density.shape),
        "compliance": result.compliance,
        "binary_compliance": result.binary_compliance,
        "binary_volume": result.binary_volume,
    }), flush=True)
    return result


if __name__ == "__main__":
    main()
