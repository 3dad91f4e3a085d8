"""Where the time of an OC step goes on the card: classic SIMP-OC through
``ground_truth_topopt``, with the CUDA kernels on and off.

    python -m ndr_tpu_torch.utils.profile_oc \\
        [--prob problems/3d/cantilever_flexion.json] [--grid "[192,96,96]"] \\
        [--mgl 3] [--steps 3] [--kernels on,off] [--smoother chebyshev|gs] \\
        [--precond-lag K] [--scan C] [--settings '{"cached_ke_dtype": "bfloat16"}'] \\
        [--warm N] [--x64] [--optim OC|LBFGS]

For each kernels setting it runs ``2 + steps + 1`` OC steps on CUDA:

1. two warm-up steps, untimed;
2. ``steps`` timed steps: their median wall time, and per step the port's
   spans (``utils/timers``: host ms, self ms and calls of each, read from
   the registry; a step ends on host reads, so its spans hold the waits
   for the card) and counters (CG iterations, host reads, bisection
   evaluations, ...);
3. one step traced with ``torch.profiler``: its wall time, the device's
   busy time (the summed durations of its kernels, memcpys and memsets,
   which run on one stream and do not overlap), the idle share 1 - busy /
   wall, the number of device ops, the device ops that took the most time,
   and each span's device ms (the kernels launched inside it, its child
   spans' included).

``--precond-lag`` and ``--scan`` run the trainer's lagged preconditioner
and chunked loop, ``--settings`` a JSON object of ``MGSolverSettings``
fields to replace. With ``--scan`` the callbacks come at chunk boundaries
(on CUDA the preconditioner replays from a CUDA graph, whose capture falls
in the first chunk), so the run is three chunks instead: one of warm-up,
one timed, and one traced, whose wall, busy time, device ops and span
device times are reported per step. Each run also prints its hierarchy
builds and the graph's captures, replays and capture seconds. ``--warm N`` starts each
run from the design of N fresh OC steps (untimed), as the JAX package's
``scripts/profile_oc.py --warm`` does: from the uniform start a lagged
hierarchy stalls CG after the first large OC moves.

``--x64`` runs the problem in float64 (the float64 kernels with kernels
on). ``--optim LBFGS`` profiles the L-BFGS optimizer instead, with one
inner iteration in the place of an OC step (the optimizer calls the
callback after each): two iterations of warm-up, ``steps`` timed, one
traced; an iteration's line search runs one or more objective
evaluations (solves), reported per iteration.

With ``--smoother gs`` the GS sweeps are also tallied per level: in the
timed steps each sweep is timed between two syncs (sweeps per step, ms
per sweep, their share of the ``solve`` span), and after the run one sweep of
each level, on the operands of its last call, is traced on its own: its
device ops (launches per sweep), its device busy time and the idle share
1 - busy / (synced ms per sweep), and the port's kernel launches in it.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import math
import statistics
import time
from collections import defaultdict

import torch

from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils import timers
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

WARMUP = 2
TOP_OPS = 16
#: Name stems of the port's own CUDA kernels (``ndr_tpu_torch/csrc/``),
#: reported whether or not they are among the top device ops.
PORT_KERNELS = ("apply_k_fine_stream_kernel", "cached_apply_kernel",
                "cached_stencil_kernel", "apply_k_fine_kernel",
                "elem_blocks_kernel", "stitch_faces",
                "apply_k_elem_partials", "sum_elem_partials")

@contextlib.contextmanager
def gs_sweep_tally(on: list, seconds: dict, calls: dict, last: dict):
    """Wrap ``multigrid.gs_sweep``: while ``on[0]`` is true each sweep is
    timed between two syncs into ``seconds`` / ``calls`` keyed by its
    level's node dims; ``last`` keeps each level's latest operands."""
    fn = mg.gs_sweep

    def timed(lv, u, b, forward=True):
        key = lv.grid.nodes_per_dim
        last[key] = (lv, u, b, forward)
        if not on[0]:
            return fn(lv, u, b, forward)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(lv, u, b, forward)
        torch.cuda.synchronize()
        seconds[key] += time.perf_counter() - t0
        calls[key] += 1
        return out

    mg.gs_sweep = timed
    try:
        yield
    finally:
        mg.gs_sweep = fn


def report_gs_sweeps(tag: str, seconds, calls, last, steps: int, solve_s: float):
    """Per level: sweeps per step, synced ms per sweep, share of the
    solve (``solve_s``: the ``solve`` span's seconds over the same ``steps``)
    and one traced sweep's device ops, busy time and idle share."""
    for key in sorted(last, key=lambda k: -math.prod(k)):
        lv, u, b, forward = last[key]
        n = calls[key]
        ms = 1e3 * seconds[key] / max(n, 1)
        mg.gs_sweep(lv, u, b, forward)  # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            mg.gs_sweep(lv, u, b, forward)
            torch.cuda.synchronize()
        busy, n_ops, _, _ = device_summary(prof)
        used = {k: v for k, v in kernels.launches.items() if v}
        print(f"{tag} GS sweep level {lv.grid.dims} ({lv.kind}"
              f"{', stencil' if lv.stencil is not None else ''}): "
              f"{n / steps:.1f} sweeps/step, {ms:.3f} ms/sweep (synced), "
              f"{seconds[key] / solve_s:.3f} of the solve; traced sweep: "
              f"{n_ops} device ops, busy {1e3 * busy:.3f} ms, idle share "
              f"{1 - 1e3 * busy / ms:.3f}; port kernels {used}")


def report(tag: str, unit: str, steps: int, timed, timed_stats, wall, prof,
           traced_steps: int = 1):
    """Print the timed steps' median time (in ``unit``, of ``timed``), per
    step the spans and counters of ``timed_stats`` (their registry delta
    over the ``steps`` steps), and the traced window's (``traced_steps``
    steps) device busy time, idle share, top device ops and span device
    times."""
    print(f"{tag} {unit} (median of {steps} timed steps) "
          f"{statistics.median(timed):.4f}")
    k = traced_steps
    spans = timers.to_dict(timed_stats)
    device = span_device_seconds(prof, spans)
    for name, sp in spans.items():
        print(f"{tag}   span {name:24s} host {1e3 * sp['seconds'] / steps:9.2f} ms/step "
              f"(self {1e3 * sp['self_seconds'] / steps:8.2f}), "
              f"{sp['count'] / steps:5.1f} calls/step; device "
              f"{1e3 * device[name] / k:8.2f} ms/step (traced)")
    print(f"{tag}   counters per step: " + ", ".join(
        f"{key} {v / steps:.2f}" for key, v in timers.counts(timed_stats).items() if v))
    busy, n_ops, top, port = device_summary(prof)
    what = "step" if k == 1 else f"chunk ({k} steps, per step)"
    if n_ops == 0:
        print(f"{tag} traced {what} wall {1e3 * wall / k:.1f} ms; device time not "
              "measured (the trace holds no device events)")
        return
    print(f"{tag} traced {what} wall {1e3 * wall / k:.1f} ms, device busy "
          f"{1e3 * busy / k:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_ops / k:.0f} device ops")
    for name, s, count in top:
        print(f"{tag}   {name[:72]:72s} {1e3 * s / k:8.2f} ms  x{count / k:.0f}")
    for name, s, count in port:
        print(f"{tag} port kernel {name[:60]:60s} {1e3 * s / k:8.2f} ms  x{count / k:.0f}")


def span_device_seconds(prof, names) -> dict:
    """Device seconds of the kernels (memcpys, memsets) launched inside each
    span of ``names`` in a ``torch.profiler`` trace: under the span's own
    host event or an op nested in it, its child spans' included."""
    names = set(names)
    out = defaultdict(float)
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = {e.name}, e.cpu_parent
        while p is not None:
            chain.add(p.name)
            p = p.cpu_parent
        s = sum(k.duration for k in e.kernels) * 1e-6
        for name in chain & names:
            out[name] += s
    return out


def device_summary(prof):
    """(busy seconds, device op count, [(name, seconds, count)] of the top
    ops, the same for the port's kernels) of the device events in a
    ``torch.profiler`` trace."""
    by_name = defaultdict(lambda: [0.0, 0])
    busy, n = 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s = e.time_range.elapsed_us() * 1e-6
        busy += s
        n += 1
        by_name[e.name][0] += s
        by_name[e.name][1] += 1
    ops = sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda t: -t[1])
    port = [op for op in ops if any(stem in op[0] for stem in PORT_KERNELS)]
    return busy, n, ops[:TOP_OPS], port


def profile(cfg, dims, mgl: int, steps: int, kernels_mode: str, device,
            smoother: str = "chebyshev", lag: int = 0, scan: int = 0,
            overrides=None, warm_steps: int = 0, dtype=torch.float32,
            optimizer: str = "OC"):
    tag = f"[{kernels_mode}]"
    use_kernels = {"on": True, "off": False}[kernels_mode]
    init = None
    if warm_steps:
        init = ground_truth_topopt(
            cfg, dims=dims, max_iter=warm_steps, multigrid_levels=mgl,
            smoother=smoother, use_kernels=use_kernels, device=device,
            log=lambda s: None, solver_overrides=overrides, dtype=dtype).densities
    on, timed = [False], {}
    gs_s, gs_n, gs_last = defaultdict(float), defaultdict(int), {}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    if scan > 1:  # three chunks: warm-up (the capture), timed, traced
        chunk = max(1, scan // lag) * lag if lag > 1 else scan
        warm, n_timed, n_traced = chunk, chunk, chunk
    else:
        warm, n_timed, n_traced = WARMUP, steps, 1
    traced = warm + n_timed   # the first traced step
    total = traced + n_traced
    lbfgs_run = optimizer == "LBFGS"

    def callback(idx, state):
        # runs after step idx (chunked: after the chunk that ends at idx):
        # snapshot the registry around the timed steps, trace the rest
        on[0] = warm - 1 <= idx < traced - 1
        if idx == warm - 1:
            timed.update(timers.counters)
        elif idx == traced - 1:
            timed.update(timers.delta(timed))
            torch.cuda.synchronize()
            prof.start()
        elif idx == total - 1:
            torch.cuda.synchronize()
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    tally = gs_sweep_tally(on, gs_s, gs_n, gs_last) if scan <= 1 else contextlib.nullcontext()
    with tally:
        result = ground_truth_topopt(
            cfg, dims=dims, max_iter=total, multigrid_levels=mgl,
            smoother=smoother, use_kernels=use_kernels, init=init,
            device=device, callback=callback, log=lambda s: None,
            precond_lag=lag, scan_chunk=scan, solver_overrides=overrides,
            dtype=dtype, optimizer=optimizer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(result.step_seconds) < total:
        raise RuntimeError(f"{optimizer} stopped after {len(result.step_seconds)} "
                           f"iterations, before the {total} profiled")

    traced_wall = sum(result.step_seconds[traced:total])
    report(tag, "s/OC-iter" if not lbfgs_run else "s per L-BFGS iteration", n_timed,
           result.step_seconds[warm:traced], timed, traced_wall, prof, n_traced)
    if lbfgs_run:
        n_it = len(result.step_seconds)
        print(f"{tag} L-BFGS: {n_it} inner iterations, {result.evaluations} objective "
              f"evaluations ({result.evaluations / n_it:.2f} per iteration), run wall "
              f"{result.solver_stats['LBFGS optimization.s']:.3f} s")
    st = result.solver_stats
    print(f"{tag} peak memory {peak:.2f} GiB; {total} "
          f"{'iterations' if lbfgs_run else 'steps'}: hierarchy builds "
          f"{st['hierarchy_builds']}, graph captures {st['graph_captures']} "
          f"({st['graph_capture_seconds']:.3f} s), replays {st['graph_replays']}")
    if gs_last:
        report_gs_sweeps(tag, gs_s, gs_n, gs_last, n_timed, timed["solve.s"])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prob", default="problems/3d/cantilever_flexion.json")
    p.add_argument("--grid", default="[192,96,96]")
    p.add_argument("--mgl", default=3, type=int)
    p.add_argument("--steps", default=3, type=int)
    p.add_argument("--kernels", default="on,off")
    p.add_argument("--smoother", default="chebyshev", choices=mg.SMOOTHERS)
    p.add_argument("--precond-lag", default=0, type=int)
    p.add_argument("--scan", default=0, type=int)
    p.add_argument("--settings", default=None,
                   help='JSON object of MGSolverSettings fields to replace, e.g. '
                        '\'{"lmax_power_iters": 8}\'')
    p.add_argument("--warm", default=0, type=int,
                   help="start from the design of this many fresh OC steps")
    p.add_argument("--x64", action="store_true", help="the problem in float64")
    p.add_argument("--optim", default="OC", choices=["OC", "LBFGS"])
    args = p.parse_args(argv)
    if args.optim == "LBFGS" and (args.precond_lag > 1 or args.scan > 1):
        p.error("--optim LBFGS takes neither --precond-lag nor --scan (OC only)")

    setup()
    device = resolve_device("cuda")
    cfg = load_problem(args.prob)
    dims = tuple(ast.literal_eval(args.grid))
    overrides = json.loads(args.settings) if args.settings else None
    print(f"profile_oc: {args.prob} {dims} mgl={args.mgl} smoother={args.smoother} "
          f"precond_lag={args.precond_lag} scan={args.scan} settings={overrides} "
          f"warm={args.warm} x64={args.x64} optim={args.optim}")
    for kernels_mode in args.kernels.split(","):
        profile(cfg, dims, args.mgl, args.steps, kernels_mode, device, args.smoother,
                args.precond_lag, args.scan, overrides, args.warm,
                torch.float64 if args.x64 else torch.float32, args.optim)


if __name__ == "__main__":
    main()
