"""CLI: evaluate a trained Fourier-feature model at a test resolution
(counterpart of ``ndr_tpu/eval/eval_fourfeat.py``). The checkpoint is a
format-2 ``.npz`` as ``train_xdg`` writes it.

Example:
    python -m ndr_tpu_torch.eval.eval_fourfeat --prob problems/3d/bridge.json \\
        --checkpoint logs/ff/run.npz --grid "[128, 64, 32]" --mgl 3 --device cuda
"""

from __future__ import annotations

import argparse
import ast
import json
import sys

import numpy as np

from ndr_tpu_torch.eval.evaluate import default_dtype, evaluate_model_at_resolution
from ndr_tpu_torch.io import export
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.utils import checkpoint as ckpt
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prob", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--grid", required=True, help="test resolution")
    p.add_argument("--es", default=1024, type=int)
    p.add_argument("--nn", default=512, type=int)
    p.add_argument("--nl", default=4, type=int)
    p.add_argument("--vcs", default="constrained_sigmoid")
    p.add_argument("--mgl", default=1, type=int)
    p.add_argument("--tol", default=1e-7, type=float)
    p.add_argument("--out", default=None, help="optional .vtr/.npy output prefix")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; asking for cuda without "
                        "a card raises, it never falls back to the CPU)")
    args = p.parse_args(argv)

    setup()
    device = resolve_device(args.device)
    cfg = load_problem(args.prob)
    test_dims = tuple(ast.literal_eval(args.grid))
    mlp_cfg = mlp.MLPConfig(
        in_features=len(test_dims), out_features=1, n_neurons=args.nn,
        n_layers=args.nl, embedding_size=args.es, scale=1.0,
        output_activation=None if vol.is_hard_mode(args.vcs) else "sigmoid",
    )
    model = mlp.FourierFeatureMLP(mlp_cfg, dtype=default_dtype(device), device=device)
    scale, step = ckpt.load_checkpoint(args.checkpoint, model)
    sys.stderr.write(f"Loaded checkpoint (sigma={scale}, step={step})\n")

    result = evaluate_model_at_resolution(
        cfg, model, test_dims, volume_constraint_satisfier=args.vcs,
        multigrid_levels=args.mgl, tol=args.tol, mg_iterations=2, device=device,
    )
    print(json.dumps({
        "test_resolution": list(test_dims),
        "compliance": result.compliance,
        "binary_compliance": result.binary_compliance,
        "binary_volume": result.binary_volume,
    }), flush=True)
    if args.out:
        np.save(args.out + "_densities.npy", result.density)
        export.write_vtr(args.out, {"density": result.density})
    return result


if __name__ == "__main__":
    main()
