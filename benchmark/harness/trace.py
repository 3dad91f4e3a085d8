"""What a traced stretch leaves for the per-layer readers: the device's
events, the host ops that launched them, and the busy time, with the
``breakdown`` of the result line. Events stay in memory; nothing is
written. Busy time is the sum of the device events' durations, as the
program's ``utils/profile_oc.device_summary`` takes it (one stream)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10


def profiler():
    """A started ``torch.profiler`` of the host and the card, events kept
    in memory."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _ancestors(e) -> List[str]:
    names = []
    p = e.cpu_parent
    while p is not None:
        names.append(p.name)
        p = p.cpu_parent
    return names


def record(prof) -> dict:
    """Device events [(name, start s, seconds)], kernels by the host op that
    launched them [(op, ancestors, seconds)], busy seconds, and host ops
    [(start s, end s, name)]."""
    import torch

    device, launched, host = [], [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, e.time_range.start * 1e-6,
                           e.time_range.elapsed_us() * 1e-6))
            continue
        host.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name))
        if e.kernels:
            launched.append((e.name, _ancestors(e),
                             sum(k.duration for k in e.kernels) * 1e-6))
    busy = sum(d for _, _, d in device)
    return {"device": device, "launched": launched, "host": host, "busy_s": busy}


def breakdown(rec: dict) -> Dict[str, List[Tuple[str, float]]]:
    """The device ops that took most time, and the longest idle gaps of the
    device named by the innermost host op open when each began."""
    by_name = defaultdict(float)
    for name, _, s in rec["device"]:
        by_name[name] += s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = sorted((t, t + s) for _, t, s in rec["device"])
    gaps, end = [], None
    for t0, t1 in spans:
        if end is not None and t0 > end:
            gaps.append((t0 - end, end))
        end = t1 if end is None else max(end, t1)
    gaps.sort(reverse=True)
    host = sorted(rec["host"])
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:TOP]:
        i = bisect.bisect_right(starts, at)
        inner = next((name for h0, h1, name in reversed(host[max(0, i - 2000):i])
                      if h1 >= at), "idle")
        named.append((inner, length))
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in named]}
