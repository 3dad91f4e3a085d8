"""Where the time of an OC step goes on the card: classic SIMP-OC through
``ground_truth_topopt``, with the CUDA kernels on and off.

    python -m ndr_tpu_torch.utils.profile_oc \\
        [--prob problems/3d/cantilever_flexion.json] [--grid "[192,96,96]"] \\
        [--mgl 3] [--steps 3] [--kernels on,off]

For each kernels setting it runs ``2 + steps + 1`` OC steps on CUDA:

1. two warm-up steps, untimed;
2. ``steps`` steps with the card synchronized around each named section
   of :data:`SECTIONS` (hierarchy build, coarsest dense K + factor, MG
   preconditioner, whole solve, adjoint gradient, constraint gradient).
   The syncs make each section an upper bound, and the first three are
   parts of "solve total";
3. one step traced with ``torch.profiler``, without those syncs: its wall
   time, the device's busy time (the summed durations of its kernels,
   memcpys and memsets, which run on one stream and do not overlap), the
   idle share 1 - busy / wall, the number of device ops, and the device
   ops that took the most time.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import statistics
import time
from collections import defaultdict

import torch

from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

WARMUP = 2
TOP_OPS = 16
#: Name stems of the port's own CUDA kernels (``ndr_tpu_torch/csrc/``),
#: reported whether or not they are among the top device ops.
PORT_KERNELS = ("apply_k_fine_stream_kernel", "cached_apply_kernel",
                "cached_stencil_kernel", "apply_k_fine_kernel",
                "elem_blocks_kernel", "stitch_faces",
                "apply_k_elem_partials", "sum_elem_partials")

#: (label, owner, attribute) of each synchronized section.
SECTIONS = (
    ("hierarchy: Galerkin Ke + diag blocks", mg, "build_level_states"),
    ("coarsest: dense K + factor", mg, "factor_coarsest"),
    ("MG preconditioner", mg, "mg_preconditioner"),
    ("solve total", mg, "mgpcg_solve"),
    ("adjoint gradient + filter backprop",
     topopt.TopologyOptimizationProblem, "objective_gradient"),
    ("constraint gradient", topopt.TopologyOptimizationProblem,
     "constraint_gradient"),
)


@contextlib.contextmanager
def synced_sections(on: list, seconds: dict, calls: dict, sections=SECTIONS):
    """Wrap each function of ``sections`` (label, owner, attribute) so
    that, while ``on[0]`` is true, the card is synchronized around the
    call and its wall time is added to ``seconds[label]``."""
    saved = []
    for label, owner, attr in sections:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*args, _fn=fn, _label=label, **kwargs):
            if not on[0]:
                return _fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[_label] += time.perf_counter() - t0
            calls[_label] += 1
            return out

        setattr(owner, attr, timed)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def report(tag: str, unit: str, sections, seconds, calls, steps: int, synced,
           wall, prof):
    """Print the synced steps' median time (in ``unit``), the sections'
    ms/step and the traced step's device busy time, idle share and top
    device ops."""
    print(f"{tag} {unit} with synced sections (median of {steps} steps) "
          f"{statistics.median(synced):.4f}")
    for label, *_ in sections:
        print(f"{tag}   {label:40s} {1e3 * seconds[label] / steps:9.2f} ms/step"
              f"  ({calls[label] / steps:.1f} calls/step)")
    busy, n_ops, top, port = device_summary(prof)
    if n_ops == 0:
        print(f"{tag} traced step wall {1e3 * wall:.1f} ms; device time not "
              "measured (the trace holds no device events)")
        return
    print(f"{tag} traced step wall {1e3 * wall:.1f} ms, device busy "
          f"{1e3 * busy:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_ops} device ops")
    for name, s, count in top:
        print(f"{tag}   {name[:72]:72s} {1e3 * s:8.2f} ms  x{count}")
    for name, s, count in port:
        print(f"{tag} port kernel {name[:60]:60s} {1e3 * s:8.2f} ms  x{count}")


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


def profile(cfg, dims, mgl: int, steps: int, kernels: str, device):
    tag = f"[{kernels}]"
    on, seconds, calls = [False], defaultdict(float), defaultdict(int)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    traced = WARMUP + steps

    def callback(idx, state):
        # runs after step idx: switch the timing mode of step idx + 1
        on[0] = WARMUP - 1 <= idx < traced - 1
        if idx == traced - 1:
            torch.cuda.synchronize()
            prof.start()
        elif idx == traced:
            torch.cuda.synchronize()
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    with synced_sections(on, seconds, calls):
        result = ground_truth_topopt(
            cfg, dims=dims, max_iter=traced + 1, multigrid_levels=mgl,
            use_kernels={"on": True, "off": False}[kernels], device=device,
            callback=callback, log=lambda s: None)
    peak = torch.cuda.max_memory_allocated() / 2**30

    report(tag, "s/OC-iter", SECTIONS, seconds, calls, steps, result.step_seconds[WARMUP:traced],
           result.step_seconds[traced], prof)
    print(f"{tag} peak memory {peak:.2f} GiB")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prob", default="problems/3d/cantilever_flexion.json")
    p.add_argument("--grid", default="[192,96,96]")
    p.add_argument("--mgl", default=3, type=int)
    p.add_argument("--steps", default=3, type=int)
    p.add_argument("--kernels", default="on,off")
    args = p.parse_args(argv)

    setup()
    device = resolve_device("cuda")
    cfg = load_problem(args.prob)
    dims = tuple(ast.literal_eval(args.grid))
    print(f"profile_oc: {args.prob} {dims} mgl={args.mgl}")
    for kernels in args.kernels.split(","):
        profile(cfg, dims, args.mgl, args.steps, kernels, device)


if __name__ == "__main__":
    main()
