"""Where a cell's step goes, by the program's spans: one traced run of a
cell, and a table per span.

    python3 benchmark/span_report.py --workload <cell> --seed <n> --seconds <s> \\
        [--sync-check 1] [--micro 1] [--out build/span_report]

Runs the cell as ``run.py --trace 1`` does (window, then the traced
stretch) and prints, per span of the program's registry: host ms, self ms
and calls per step over the untraced window; device ms per step of the
kernels launched inside it, of those launched with it innermost (and
the four kernel names that took most of these), and of
those launched on another thread (autograd's engine runs backward on its
own) while it was the innermost span open, and device idle ms per step
while it was innermost, over the traced stretch (the profiler slows the
host, so traced idle time reads high); then the shares of the traced busy
time launched inside some span (by ancestry, and by time as well) and of
the idle time with some span open, the device events named like a
span (a span must not be one), the new per-layer metrics and the longest
idle gaps. ``--sync-check 1`` runs one more boundary interval after the
traced stretch under ``torch.cuda.set_sync_debug_mode("warn")`` and
counts the card's synchronizations by the program's line that caused
them, against the ``host_reads`` counter over the same steps. ``--micro
1`` times one span (profiler off and on), one counter increment and one
counted read of a device scalar against ``.item()``. Writes the whole as
JSON under ``--out``. Needs a card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import session as hs, spans, trace as tr  # noqa: E402
from benchmark.harness.program import Context  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


class SyncCheck:
    """One boundary interval after the traced stretch under the sync debug
    mode: each synchronization the card makes is a warning, tallied by the
    program's frame that caused it (a frame of the timers module is
    skipped for its caller)."""

    def __init__(self):
        self.state = "off"
        self.sites = Counter()
        self.steps = self.reads = 0
        self._ctx = None

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "ndr_tpu_torch" in f.filename and "timers.py" not in f.filename]
        f = frames[-1] if frames else None
        self.sites["?" if f is None else
                   f"{f.filename.split('ndr_tpu_torch/')[-1]}:{f.lineno} {f.name}"] += 1

    def start(self, sess):
        import torch

        self.state, self._steps0 = "on", sess.steps
        self._reads0 = sess.stats.get("host_reads", 0)
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._hook
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self, sess, steps):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(None, None, None)
        self.state = "done"
        self.steps = steps - self._steps0
        self.reads = sess.stats.get("host_reads", 0) - self._reads0

    def install(self):
        boundary, check = hs.Session.boundary, hs.Session.check
        chk = self

        def patched_boundary(sess, steps):
            if sess.done and chk.state == "on":
                chk.stop(sess, steps)
                return "done"
            return boundary(sess, steps)

        def patched_check(sess):
            if sess.done and chk.state == "off":
                chk.start(sess)
            elif chk.state != "on":
                check(sess)

        hs.Session.boundary, hs.Session.check = patched_boundary, patched_check

    def result(self) -> dict:
        n = max(self.steps, 1)
        return {"steps": self.steps, "syncs_per_step": sum(self.sites.values()) / n,
                "host_reads_per_step": self.reads / n,
                "sites_per_step": {k: v / n for k, v in self.sites.most_common()}}


def micro() -> dict:
    """Microseconds of one span (profiler off, on), one counter increment,
    one counted read and one ``.item()`` of a device scalar."""
    import torch
    from ndr_tpu_torch.utils import timers

    def per_call(fn, n):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t) / n

    sp = timers.span("micro.span")

    def one_span():
        with sp:
            pass

    x = torch.ones((), device="cuda")
    out = {"span_us": per_call(one_span, 200000),
           "count_us": per_call(lambda: timers.count("micro.count"), 200000),
           "read_us": per_call(lambda: timers.read(x), 20000),
           "item_us": per_call(x.item, 20000)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        out["span_profiled_us"] = per_call(one_span, 20000)
    return out


def by_launch(prof, names):
    """[(launch s, device s)] of the kernels whose launching op has no span
    among its ancestors: those launched on another thread than the spans'
    (autograd's engine runs backward on a thread of its own), or outside
    every span; and per innermost span, the device seconds of each kernel
    name launched inside it."""
    orphans, kernels = [], {}
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = [e.name], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        inner = next((n for n in chain if n in names), None)
        if inner is None:
            orphans.append((e.time_range.start * 1e-6,
                            sum(k.duration for k in e.kernels) * 1e-6))
            continue
        c = kernels.setdefault(inner, Counter())
        for k in e.kernels:
            c[k.name] += k.duration * 1e-6
    return orphans, kernels


def linkage(prof) -> dict:
    """How the trace's device events map onto the host events that launched
    them: device seconds in all, seconds attached to some host event, and
    the kernel names attached for longer than they ran (attached twice)."""
    import torch

    ran, attached = Counter(), Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ran[e.name] += e.time_range.elapsed_us() * 1e-6
        for k in e.kernels:
            attached[k.name] += k.duration * 1e-6
    excess = {n: attached[n] - ran[n] for n in attached if attached[n] > ran[n] * 1.0001}
    return {"device_s": sum(ran.values()), "attached_s": sum(attached.values()),
            "unattached_s": sum(max(ran[n] - attached[n], 0.0) for n in ran),
            "attached_twice": dict(sorted(excess.items(), key=lambda kv: -kv[1])[:8])}


def table(rec: dict, orphans: list, kernels: dict, links: dict) -> dict:
    """Per span: window host ms/step, self ms/step, calls/step; traced
    device ms/step under it, with it innermost (``kernels``), and launched
    on another thread (``orphans``, see :func:`by_launch`) while it was the
    innermost span open; idle ms/step while it was innermost. And the
    coverage of busy and idle time by spans: busy time launched under a
    span by ancestry, and busy time not launched outside every span (by
    time as well; ``links`` says how much no host event launched)."""
    names = spans.span_names(rec)
    w, steps = rec["counters"]["stats_window"], rec["counters"]["steps"]
    t = rec["trace"]
    k = t["steps"]
    inner = {n: sum(c.values()) for n, c in kernels.items()}
    idle, idle_total = spans.idle_by_span(rec, names)
    segs = spans.innermost(t["host"], names)
    by_time, outside = Counter(), 0.0
    starts = [a for a, _, _ in segs]
    for at, s in sorted(orphans):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and segs[i][1] >= at:
            by_time[segs[i][2]] += s
        else:
            outside += s
    rows = {}
    for n in names:
        if not (w.get(n + ".n") or inner.get(n) or idle.get(n) or by_time.get(n)):
            continue
        rows[n] = {"host_ms": 1e3 * w.get(n + ".s", 0.0) / steps,
                   "self_ms": 1e3 * w.get(n + ".self_s", 0.0) / steps,
                   "calls": w.get(n + ".n", 0) / steps,
                   "device_ms": 1e3 * (spans.device_s_under(rec, n) or 0.0),
                   "device_inner_ms": 1e3 * inner.get(n, 0.0) / k,
                   "device_other_thread_ms": 1e3 * by_time.get(n, 0.0) / k,
                   "idle_inner_ms": 1e3 * idle.get(n, 0.0) / k}
    busy = t["busy_s"]
    in_spans = spans.busy_under_spans(rec, names)
    return {"spans": dict(sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"])),
            "busy_ms": 1e3 * busy / k, "idle_ms": 1e3 * idle_total / k,
            "busy_in_spans": in_spans / busy if busy else None,
            "busy_in_spans_by_time": (1 - (outside + links["unattached_s"]) / busy
                                      if busy else None),
            "busy_outside_spans_ms": 1e3 * outside / k,
            "idle_in_spans": sum(idle.values()) / idle_total if idle_total else None,
            "device_events_named_as_spans": sorted({n for n, _, _ in t["device"]
                                                    if n in names}),
            # a user annotation (record_function) shows as a device event too
            "device_events_named_as_host_ops_ms": {
                n: 1e3 * sum(s for m, _, s in t["device"] if m == n) / k
                for n in {n for n, _, _ in t["device"]} & {h[2] for h in t["host"]}},
            "counters_per_step": {key: v / steps for key, v in w.items()
                                  if v and not any(key == n + sfx for n in names
                                                   for sfx in (".s", ".self_s", ".n"))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sync-check", type=int, choices=(0, 1), default=0)
    ap.add_argument("--micro", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_report"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    chk = SyncCheck() if args.sync_check else None
    if chk is not None:
        chk.install()
    ctx = Context(config, spec.traffic(cell["traffic"]), args.seed, args.seconds, True, T0)
    sess, _ = spec.driver(config["driver"]).run(ctx)
    w = sess.window
    orphans, kernels = by_launch(sess.prof,
                                 set(spans.span_names({"counters": sess.counters()})))
    rec = {"cell": cell, "config": config, "setup_s": w.t_open - T0,
           "peak_bytes": sess.peak_bytes,
           "window": {"steps": w.steps, "seconds": w.wall, "step_s": w.step_seconds},
           "counters": sess.counters(),
           "trace": dict(tr.record(sess.prof), seconds=sess.trace_seconds,
                         steps=sess.trace_steps)}
    out = {"cell": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "step_ms": 1e3 * w.step_seconds, "window_steps": w.steps,
           "traced_wall_ms": 1e3 * rec["trace"]["seconds"] / rec["trace"]["steps"],
           "traced_steps": rec["trace"]["steps"]}
    out["linkage"] = linkage(sess.prof)
    out.update(table(rec, orphans, kernels, out["linkage"]))
    k = rec["trace"]["steps"]
    out["top_kernels_ms"] = {n: [[name[:90], 1e3 * s / k] for name, s in c.most_common(4)]
                             for n, c in kernels.items()}
    out["metrics"] = {m["name"]: spec.metric(m["name"]).read(rec)
                      for m in spec.metrics("per_layer", args.workload)}
    out["breakdown"] = tr.breakdown(rec["trace"])
    if chk is not None:
        out["sync_check"] = chk.result()
    if args.micro:
        out["micro"] = micro()
    print(f"span_report {args.workload} seed {args.seed}: step {out['step_ms']:.2f} ms "
          f"untraced, traced {out['traced_wall_ms']:.2f} ms; busy {out['busy_ms']:.2f} ms "
          f"and idle {out['idle_ms']:.2f} ms a traced step")
    print(f"{'span':24s} {'host ms':>9s} {'self ms':>9s} {'calls':>6s} {'dev ms':>9s} "
          f"{'dev inner':>9s} {'dev other':>9s} {'idle inner':>10s}")
    for n, r in out["spans"].items():
        print(f"{n:24s} {r['host_ms']:9.3f} {r['self_ms']:9.3f} {r['calls']:6.2f} "
              f"{r['device_ms']:9.3f} {r['device_inner_ms']:9.3f} "
              f"{r['device_other_thread_ms']:9.3f} {r['idle_inner_ms']:10.3f}")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}_{args.seed}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
