"""MG accuracy/cost envelope sweep (counterpart of ``scripts/mg_benchmark.py``,
with ``scripts/envelope_table.py`` as ``--table``; the reference's
methodology: VoxelFEM/python/MGBenchmark.ipynb cells 8-14).

For a set of random mid-optimisation density fields on the 3-D cantilever
(salt and pepper, 0.05 or 1.0, smoothed by a radius-2 box filter, drawn
from ``np.random.default_rng(0)``) it solves for a ground-truth
displacement at tol 1e-9 (400 CG iterations, Chebyshev) once per (Emin,
field), then sweeps Emin x CG tol x {zero start, warm start from the
previous field's solution} and records the mean displacement error, the
mean compliance error and the mean CG iterations of each operating point.

    python -m ndr_tpu_torch.utils.mg_benchmark --fields 100 --refined --kernels on
    python -m ndr_tpu_torch.utils.mg_benchmark --dims "[8,4,4]" --fields 2 \\
        --levels 1 --device cpu
    python -m ndr_tpu_torch.utils.mg_benchmark --table envelope.jsonl

Prints one JSON line per operating point, then ``{"table": [...]}``;
``--table PATH`` instead renders such output as the README's markdown
table. ``--refined`` runs the sweep's solves (and the ground truth) as the
production path does: the fp32 MGPCG inside float64 iterative refinement.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
from typing import Callable, List

import numpy as np
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.ops.filters import SmoothingFilter
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

PROB = "problems/3d/cantilever_flexion.json"
EMINS = (1e-2, 1e-4, 1e-6)
TOLS = (1e-2, 1e-4, 1e-6)
REF_TOL, REF_CG_ITER = 1e-9, 400
KERNELS = {"auto": "auto", "on": True, "off": False}


def density_fields(dims, n: int) -> List[np.ndarray]:
    """The sweep's ``n`` fields (float64): smoothed salt and pepper, like a
    mid-optimisation state, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    smoother = SmoothingFilter(radius=2)
    return [smoother.apply(torch.from_numpy(
                np.where(rng.uniform(size=dims) < 0.5, 0.05, 1.0))).numpy()
            for _ in range(n)]


def sweep(dims=(64, 32, 32), n_fields: int = 10, levels: int = 3, refined: bool = False,
          use_kernels="auto", device="cuda",
          emit: Callable[[dict], None] = lambda row: None) -> List[dict]:
    """The 18 operating points, in the JAX script's order; ``emit`` gets
    each row as it is done."""
    device = torch.device(device)
    cfg = load_problem(PROB)
    fields = [torch.tensor(f, dtype=torch.float32, device=device)
              for f in density_fields(tuple(dims), n_fields)]
    rows = []
    for emin in EMINS:
        prob, _ = problem_from_config(cfg, dims=tuple(dims), dtype=torch.float32,
                                      device=device)
        prob = dataclasses.replace(prob, Emin=emin)

        def compliance(u):
            return float(prob.force.reshape(-1).to(u.dtype) @ u.reshape(-1))

        solve_ref = mg.make_mg_solver(prob, mg.MGSolverSettings(
            num_levels=levels, cg_iter=REF_CG_ITER, tol=REF_TOL, smoother="chebyshev",
            use_kernels=use_kernels, mixed_precision=refined))
        refs = []  # once per (Emin, field); the 6 (tol, warm) points reuse it
        for rho in fields:
            u_ref, _ = solve_ref(rho, None)
            refs.append((u_ref, compliance(u_ref)))
        for tol in TOLS:
            for warm in (False, True):
                solve = mg.make_mg_solver(prob, mg.MGSolverSettings(
                    num_levels=levels, cg_iter=REF_CG_ITER, tol=tol, smoother="chebyshev",
                    zero_init=not warm, use_kernels=use_kernels, mixed_precision=refined))
                u_errs, c_errs, iters_all = [], [], []
                u_prev = None
                for rho, (u_ref, c_ref) in zip(fields, refs):
                    u, it = solve(rho, u_prev if warm else None)
                    if warm:
                        u_prev = u
                    u_errs.append(float(torch.linalg.norm((u - u_ref).reshape(-1))
                                        / torch.linalg.norm(u_ref.reshape(-1))))
                    c_errs.append(abs(compliance(u) - c_ref) / abs(c_ref))
                    iters_all.append(int(it))
                rows.append({"Emin": emin, "tol": tol, "warm": warm,
                             "u_err_mean": float(np.mean(u_errs)),
                             "c_err_mean": float(np.mean(c_errs)),
                             "cg_iters_mean": float(np.mean(iters_all))})
                emit(rows[-1])
    return rows


def table(lines) -> str:
    """The README's markdown table from the JSON lines of a sweep."""
    rows = [json.loads(l) for l in lines if l.strip().startswith("{")]
    rows = [r for r in rows if "Emin" in r]  # skip the trailing summary
    out = ["| Emin | cg tol | warm start | mean ‖u-u*‖/‖u*‖ | mean |c-c*|/c* | mean CG iters |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['Emin']:g} | {r['tol']:g} | {'yes' if r['warm'] else 'no'} "
                   f"| {r['u_err_mean']:.2e} | {r['c_err_mean']:.2e} "
                   f"| {r['cg_iters_mean']:.2f} |")
    return "\n".join(out)


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dims", default="[64,32,32]")
    p.add_argument("--fields", default=10, type=int)
    p.add_argument("--levels", default=3, type=int)
    p.add_argument("--kernels", default="auto", choices=list(KERNELS),
                   help="hand-written CUDA stiffness kernels (auto: on for CUDA tensors)")
    p.add_argument("--refined", action="store_true",
                   help="solve through the production mixed-precision path (fp32 "
                        "MGPCG inside float64 iterative refinement)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card that raises)")
    p.add_argument("--table", default=None, metavar="PATH",
                   help="render the JSON lines in PATH as a markdown table instead")
    args = p.parse_args(argv)
    if args.table:
        with open(args.table) as f:
            print(table(f))
        return []
    setup()
    rows = sweep(tuple(ast.literal_eval(args.dims)), args.fields, args.levels,
                 args.refined, KERNELS[args.kernels], resolve_device(args.device),
                 emit=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps({"table": rows}))
    return rows


if __name__ == "__main__":
    main()
