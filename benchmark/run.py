"""The benchmark of ndr_tpu_torch: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic by name, drives the program's
entry through the configuration's driver, measures the window, judges
what the run produced against the plain reference, and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last the ``checks``: each number
compared with its limit. Exits non-zero, with no line, where there is no
card (or fewer than the cell asks for), where the program is missing,
and where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# compiler caches at fixed paths inside the checkout, so that only a cell's
# first run there compiles (the program's own kernels build into build/ too)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)

from benchmark.harness import guard, trace as tr  # noqa: E402
from benchmark.harness.program import Context  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


def execute(spec: Spec, cell_name: str, seed: int, seconds: float, trace: bool,
            t0: float, device: str = "cuda") -> dict:
    """One run of a cell on ``device``; returns the result line's fields."""
    import torch

    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(config["driver"])
    ctx = Context(config, traffic, seed, seconds, trace, t0, device)
    sess, evidence = driver.run(ctx)
    w = sess.window
    print(f"benchmark: first boundary {sess.t_first - t0:.3f} s, window open "
          f"{w.t_open - t0:.3f} s after the process started", file=sys.stderr)
    rec = {"cell": cell, "config": config, "traffic": traffic,
           "setup_s": w.t_open - t0, "peak_bytes": sess.peak_bytes,
           "window": {"steps": w.steps, "seconds": w.wall, "step_s": w.step_seconds},
           "counters": sess.counters(), "trace": None}
    if sess.prof is not None:
        rec["trace"] = dict(tr.record(sess.prof), seconds=sess.trace_seconds,
                            steps=sess.trace_steps)
        sess.prof = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    got = driver.readings(config, evidence, seed, device)
    for k, v in got.items():
        print(f"benchmark: reading {k} {v!r}", file=sys.stderr)
    checks = {k: (got[k], float(lim)) for k, lim in config["limits"].items()}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(kind, cell_name):
        v = spec.metric(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(sess.peak_bytes)}
    line = {"correct": all(math.isfinite(v) and v <= lim for v, lim in checks.values()),
            "attempted": w.steps, "failed": w.failed, "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["seconds"]
        line["breakdown"] = tr.breakdown(rec["trace"])
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
