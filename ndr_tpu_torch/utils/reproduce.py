"""The reference's headline runs through the port (counterpart of
``scripts/reproduce.sh``).

Runs the shell script's five runs, each with its exact arguments, through
``train_voxelfem.main`` / ``train_xdg.main`` on ``--device`` (default
cuda), and after each prints one JSON line: the steps run, the final soft
and binary compliance, the last trace step's compliance, seconds per OC
iteration (or per step) at step 1, step 100 and the last step and their
median, the CG iterations per step (min / median / max, summed over a
solve's refinement passes), the cap of one CG pass, the passes of the
steps that stopped at it and the longest run of consecutive steps with
such a pass, peak device memory, the kernels' launches, and the
reference log's value for the run beside the relative difference.

    python -m ndr_tpu_torch.utils.reproduce                      # all five
    python -m ndr_tpu_torch.utils.reproduce --only c3d_256
    python -m ndr_tpu_torch.utils.reproduce --only mbb300 --iter 3 \\
        --grid "[30,10]" --device cpu

``--iter`` and ``--grid`` override the runs' own values (short runs);
``--x64`` runs them in float64 end to end, as the reference's solver
does.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training import train_voxelfem, train_xdg
from ndr_tpu_torch.training.classic import default_cg_iter
from ndr_tpu_torch.training.neural import NeuralTOConfig

# jid -> (CLI, argv): scripts/reproduce.sh's five runs, argument for argument
RUNS: Dict[str, Tuple[str, List[str]]] = {
    "mbb300": ("train_voxelfem", [
        "--prob", "problems/2d/mbb_beam.json",
        "--iter", "1500", "--mgl", "2", "--jid", "mbb300", "--log-every", "100"]),
    "bridge250": ("train_voxelfem", [
        "--prob", "problems/2d/bridge.json",
        "--iter", "1500", "--mgl", "2", "--jid", "bridge250", "--log-every", "100"]),
    "c3d_256": ("train_voxelfem", [
        "--prob", "problems/3d/cantilever_flexion.json", "--grid", "[256,128,128]",
        "--iter", "2700", "--mgl", "5", "--jid", "c3d_256", "--log-every", "100"]),
    "b3d_320": ("train_voxelfem", [
        "--prob", "problems/3d/bridge.json",
        "--grid", "[320,160,80]", "--iter", "1000", "--mgl", "4", "--jid", "b3d_320",
        "--log-every", "100"]),
    "ff3d": ("train_xdg", [
        "--prob", "problems/3d/bridge.json",
        "--grid", "[64,32,16]", "--v0", "0.4", "--mgl", "2", "--sigma", "1.0",
        "--iter", "100", "--vcs", "maxed_barrier", "--jid", "ff3d", "--log-every", "10"]),
}

# the reference's logs (BASELINE.md, README.md): (quantity, value, binary,
# source). "last step": the compliance of the last OC step's trace line;
# "final": the final evaluation (the design filtered once more, then
# solved); "step 500": the trace at step 500; "it/s": training steps per
# second on a 128-core CPU node
REFERENCE = {
    "mbb300": ("last step", 316.48, 316.020, "logs/slurm/gt/2dMbb300x100.log"),
    "bridge250": ("final", 10.053, 9.812, "logs/slurm/gt/2dBridge250x125.log"),
    "c3d_256": ("final", 252.079, 251.633, "logs/slurm/gt/c1001.log"),
    "b3d_320": ("step 500", 9.399, None, "logs/slurm/gt/b1000.log"),
    "ff3d": ("it/s", 1.1, None, "logs/slurm/ff/test.log (CPU)"),
}


def run_argv(jid: str, iters: Optional[int] = None, grid: Optional[str] = None,
             device: str = "cuda", out: str = "build/reproduce",
             x64: bool = False) -> List[str]:
    """The run's argv with the overrides applied."""
    argv = list(RUNS[jid][1])
    for flag, value in (("--iter", None if iters is None else str(iters)),
                        ("--grid", grid)):
        if value is None:
            continue
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    argv += ["--device", device, "--out", out]
    if x64:
        argv += ["--x64"]
    return argv


def _flag(argv: List[str], flag: str, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def longest_run(flags: List[bool]) -> int:
    """The longest run of consecutive true flags."""
    best = run = 0
    for f in flags:
        run = run + 1 if f else 0
        best = max(best, run)
    return best


def _rel(ours, ref):
    if ours is None or ref is None:
        return None
    return (ours - ref) / ref


def cg_cap(jid: str, argv: List[str]) -> int:
    """The per-pass CG cap the run's CLI gives its solver."""
    if RUNS[jid][0] == "train_xdg":
        return NeuralTOConfig.cg_iter
    cfg = load_problem(_flag(argv, "--prob"))
    grid_arg = _flag(argv, "--grid")
    return default_cg_iter(cfg.make_grid(ast.literal_eval(grid_arg) if grid_arg else None))


def run(jid: str, **overrides) -> dict:
    """One run through its CLI; returns the JSON record."""
    cli, _ = RUNS[jid]
    argv = run_argv(jid, **overrides)
    device = torch.device(_flag(argv, "--device"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    main = train_voxelfem.main if cli == "train_voxelfem" else train_xdg.main
    kernels.reset_launches()
    res = main(argv)
    launches = {k: v for k, v in kernels.launches.items() if v}
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    secs, iters = list(res.step_seconds), list(res.cg_iters)
    cap = cg_cap(jid, argv)
    if cli == "train_voxelfem":
        soft, binary, hist = res.compliance, res.binary_compliance, res.history
    else:
        soft, binary, hist = res.final_compliance, res.binary_compliance, res.history
    quantity, ref, ref_binary, source = REFERENCE[jid]
    ours = {"last step": hist[-1], "final": soft,
            "step 500": hist[500] if len(hist) > 500 else None,
            "it/s": 1.0 / statistics.median(secs[1:]) if len(secs) > 1 else None}[quantity]
    return {
        "jid": jid, "cli": cli, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "argv": argv, "steps": len(hist),
        "compliance": soft, "binary_compliance": binary, "last_step_compliance": hist[-1],
        "s_per_step": {"step 1": secs[1] if len(secs) > 1 else None,
                       "step 100": secs[100] if len(secs) > 100 else None,
                       "last": secs[-1],
                       "median of steps 1-": statistics.median(secs[1:]) if len(secs) > 1
                       else None},
        "cg_iters": {"min": min(iters), "median": statistics.median(iters),
                     "max": max(iters), "cap": cap,
                     "passes_at_cap": sum(res.cg_passes_at_cap),
                     "longest_run_at_cap": longest_run([n > 0 for n in res.cg_passes_at_cap])},
        "peak_gib": peak, "launches": launches,
        "reference": {"quantity": quantity, "value": ref, "ours": ours,
                      "rel": _rel(ours, ref), "binary": ref_binary,
                      "binary_rel": _rel(binary, ref_binary), "source": source},
    }


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", default=",".join(RUNS),
                   help=f"comma-separated runs out of {','.join(RUNS)}")
    p.add_argument("--iter", type=int, default=None, help="override every run's --iter")
    p.add_argument("--grid", default=None, help='override every run\'s grid, e.g. "[30,10]"')
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card that raises)")
    p.add_argument("--out", default="build/reproduce", help="the runs' output directory")
    p.add_argument("--x64", action="store_true",
                   help="run in float64 end to end (the CLIs' --x64)")
    args = p.parse_args(argv)
    names = args.only.split(",")
    unknown = [n for n in names if n not in RUNS]
    if unknown:
        p.error(f"unknown runs {unknown}: choose from {list(RUNS)}")
    os.makedirs(args.out, exist_ok=True)
    records = []
    for jid in names:
        rec = run(jid, iters=args.iter, grid=args.grid, device=args.device,
                  out=args.out, x64=args.x64)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
