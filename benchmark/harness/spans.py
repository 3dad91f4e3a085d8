"""What the program's spans and counters leave for the per-layer readers.

The program (``ndr_tpu_torch/utils/timers.py``) keeps one registry of
counters, the dict the drivers hand to the session as its stats: a span
``name`` adds ``name.s`` (host seconds), ``name.self_s`` and ``name.n``
(calls) to it, and under the profiler is a host event, the ancestor of
the ops and kernel launches made inside it. A program without them (an
older one) leaves none of these keys and no such events: every function
here then returns ``None``."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def per_step(rec: dict, key: str, scale: float = 1.0) -> Optional[float]:
    """The window's delta of the counter ``key`` per step, times ``scale``;
    ``None`` where the program keeps no such counter."""
    c = rec["counters"]
    w = c["stats_window"]
    if key not in w or not c["steps"]:
        return None
    return scale * w[key] / c["steps"]


def span_names(rec: dict) -> List[str]:
    """The spans the program has (those with a call count in its registry)."""
    return [k[:-2] for k in rec["counters"]["stats_total"] if k.endswith(".n")
            and k[:-2] + ".self_s" in rec["counters"]["stats_total"]]


def device_s_under(rec: dict, span: str) -> Optional[float]:
    """Device seconds, per traced step, of the kernels launched inside
    ``span`` (by the span itself or an op nested in it); ``None`` where the
    trace has none."""
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    hits = [s for op, parents, s in t["launched"] if op == span or span in parents]
    if not hits:
        return None
    return sum(hits) / t["steps"]


def _gaps(rec: dict) -> List[Tuple[float, float]]:
    """The device's idle intervals between its first and last event."""
    gaps, end = [], None
    for t0, t1 in sorted((t, t + s) for _, t, s in rec["trace"]["device"]):
        if end is not None and t0 > end:
            gaps.append((end, t0))
        end = t1 if end is None else max(end, t1)
    return gaps


def innermost(host, names) -> List[Tuple[float, float, str]]:
    """Intervals of a traced stretch with the innermost span open in each,
    from its host events [(start s, end s, name)] (the program's spans nest
    on its one thread)."""
    names = set(names)
    spans = sorted((h0, -h1, name) for h0, h1, name in host if name in names)
    out, stack, t = [], [], None
    for h0, neg_h1, name in spans:
        h1 = -neg_h1
        while stack and stack[-1][0] <= h0:      # close what ended before this opens
            end, inner = stack.pop()
            out.append((t, end, inner))
            t = end
        if stack:
            out.append((t, h0, stack[-1][1]))
        stack.append((h1, name))
        t = h0
    while stack:
        end, inner = stack.pop()
        out.append((t, end, inner))
        t = end
    return [(a, b, n) for a, b, n in out if b > a]


def idle_by_span(rec: dict, names) -> Tuple[Dict[str, float], float]:
    """Device idle seconds by the innermost span open while the device was
    idle, and the idle seconds in all."""
    gaps = _gaps(rec)
    return overlap(innermost(rec["trace"]["host"], names), gaps), sum(b - a for a, b in gaps)


def overlap(segs, intervals) -> Dict[str, float]:
    """Seconds of ``intervals`` [(start, end)] inside each name's segments
    [(start, end, name)] (both sorted by start; segments do not overlap)."""
    starts = [a for a, _, _ in segs]
    out = defaultdict(float)
    for g0, g1 in intervals:
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            a, b, name = segs[i]
            lo, hi = max(a, g0), min(b, g1)
            if hi > lo:
                out[name] += hi - lo
            i += 1
    return dict(out)


def busy_under_spans(rec: dict, names) -> float:
    """Device seconds of the kernels launched inside any of ``names``."""
    names = set(names)
    return sum(s for op, parents, s in rec["trace"]["launched"]
               if op in names or names.intersection(parents))
