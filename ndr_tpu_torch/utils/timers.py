"""Hierarchical named-timer facade (counterpart of ``ndr_tpu/utils/timers.py``).

Wall-clock timers for host-side phases. CUDA work is asynchronous, so a
section synchronizes the card before it stops its clock when CUDA is in
use; the numbers then include the device work the section enqueued.
:func:`trace` records an on-device timeline with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class _Section:
    __slots__ = ("total", "count", "children")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.children = defaultdict(_Section)


class Benchmark:
    """Hierarchical accumulating timers with reset/report/to_dict."""

    def __init__(self, sync: bool = True):
        self._root = _Section()
        self._stack = []  # (name, start_time, section)
        self.sync = sync

    def reset(self):
        self._root = _Section()
        self._stack = []

    def start_timer_section(self, name: str):
        parent = self._stack[-1][2] if self._stack else self._root
        sec = parent.children[name]
        self._stack.append((name, time.perf_counter(), sec))

    def stop_timer_section(self, name: str):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        top_name, start, sec = self._stack.pop()
        if top_name != name:
            raise RuntimeError(f"Timer mismatch: stopping {name!r}, open {top_name!r}")
        sec.total += time.perf_counter() - start
        sec.count += 1

    @contextlib.contextmanager
    def section(self, name: str):
        self.start_timer_section(name)
        try:
            yield
        finally:
            self.stop_timer_section(name)

    def to_dict(self) -> Dict:
        def walk(sec):
            return {
                name: {
                    "seconds": child.total,
                    "count": child.count,
                    "children": walk(child),
                }
                for name, child in sec.children.items()
            }

        return walk(self._root)

    def report(self, file=None) -> str:
        lines = []

        def walk(sec, depth):
            for name, child in sec.children.items():
                lines.append(
                    f"{'  ' * depth}{name}: {child.total:.4f}s ({child.count} calls)"
                )
                walk(child, depth + 1)

        walk(self._root, 0)
        out = "\n".join(lines)
        if file is not None:
            print(out, file=file)
        return out


# module-level default instance (parity with ndr_tpu.utils.timers)
_default = Benchmark()

reset = _default.reset
start_timer_section = _default.start_timer_section
stop_timer_section = _default.stop_timer_section
section = _default.section
to_dict = _default.to_dict
report = _default.report


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
