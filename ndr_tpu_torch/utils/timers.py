"""Spans and counters of ndr_tpu_torch (counterpart of ``ndr_tpu/utils/timers.py``).

One registry, :data:`counters`, holds every count the port keeps and the
host-clock times of its spans; ``multigrid.stats`` is this same dict.

- :func:`span` times a named region on the host clock into the registry:
  ``<name>.s`` (seconds), ``<name>.self_s`` (seconds less those of the spans
  opened inside it) and ``<name>.n`` (calls). While a ``torch.profiler``
  runs, the span is also a host event of the trace (a CPU-typed record
  function, not a user annotation), the parent of the ops, ctypes kernel
  launches and CUDA-graph replays made inside it. It never synchronizes
  the card: on CUDA a span's host time is the time to enqueue its work,
  plus any wait at a blocking read inside it.
- :func:`count` adds to a counter; :func:`read` is the one way the step's
  path reads a device scalar to the host, counted under ``host_reads``.
- :func:`to_dict` and :func:`report` render the spans; :func:`trace`
  writes a ``torch.profiler`` Chrome trace, in which the spans show.

Spans nest by the order they open and close on one thread (the port's
loops run on one).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

#: The registry: counters and span times since the last :func:`reset`.
counters: Dict[str, float] = {}

# the open spans, innermost last: [child seconds in ns, record function, start ns]
_open: list = []
# each span name's three keys, made (and put in the registry) once
_keys: Dict[str, tuple] = {}


class span:
    """``with span("name"):`` or ``@span("name")``: time a region (see the
    module docstring)."""

    __slots__ = ("name", "_keys")

    def __init__(self, name: str):
        self.name = name
        keys = _keys.get(name)
        if keys is None:
            keys = _keys[name] = (name + ".s", name + ".self_s", name + ".n")
            for k, zero in zip(keys, (0.0, 0.0, 0)):
                counters.setdefault(k, zero)
        self._keys = keys

    def __enter__(self):
        rf = None
        if _profiler._is_profiler_enabled:
            rf = _RecordFunctionFast(self.name)
            rf.__enter__()
        _open.append([0, rf, time.perf_counter_ns()])
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns()
        child, rf, t0 = _open.pop()
        ns -= t0
        if _open:
            _open[-1][0] += ns
        s, self_s, n = self._keys
        c = counters
        c[s] += ns * 1e-9
        c[self_s] += (ns - child) * 1e-9
        c[n] += 1
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


def count(key: str, n=1) -> None:
    """Add ``n`` to the counter ``key``."""
    counters[key] = counters.get(key, 0) + n


def read(t: torch.Tensor):
    """``t.item()``, counted as one blocking device-to-host read
    (``host_reads``)."""
    counters["host_reads"] = counters.get("host_reads", 0) + 1
    return t.item()


def delta(since: Dict[str, float]) -> Dict[str, float]:
    """Every counter's change since the snapshot ``since`` (a ``dict`` of
    :data:`counters`), keys first made after it included."""
    return {k: v - since.get(k, 0) for k, v in counters.items()}


def reset() -> None:
    """Zero every counter and span time, in place (the dict stays the one
    that ``multigrid.stats`` names)."""
    for k, v in counters.items():
        counters[k] = type(v)()


def to_dict(stats: Dict[str, float] = None) -> Dict[str, Dict[str, float]]:
    """``{name: {"seconds", "self_seconds", "count"}}`` of the spans in
    ``stats`` (default: the registry), longest first."""
    stats = counters if stats is None else stats
    out = {n: {"seconds": stats[s], "self_seconds": stats[self_s], "count": stats[c]}
           for n, (s, self_s, c) in _keys.items() if stats.get(c)}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["seconds"]))


def counts(stats: Dict[str, float] = None) -> Dict[str, float]:
    """The entries of ``stats`` (default: the registry) that are counters,
    not span times."""
    stats = counters if stats is None else stats
    return {k: v for k, v in stats.items() if k.rpartition(".")[0] not in _keys}


def report(file=None) -> str:
    """One line per span: host seconds, self seconds and calls."""
    out = "\n".join(f"{name}: {s['seconds']:.4f}s (self {s['self_seconds']:.4f}s, "
                    f"{s['count']} calls)" for name, s in to_dict().items())
    if file is not None:
        print(out, file=file)
    return out


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """``torch.profiler`` trace context for on-device timelines (the JAX
    package's ``jax.profiler`` trace): records the host and, for a CUDA
    ``device``, the card; on exit synchronizes the card and writes a Chrome
    trace under ``logdir``. Yields the path of that file.

        with timers.trace("build/trace") as path:
            solve(rho)
    """
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
