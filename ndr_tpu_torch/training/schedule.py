"""The classic and neural drivers' step schedule: which steps build the
lagged preconditioner, how steps group into chunks, and how each step is
counted and timed before the driver's boundary work.

A run is the chunked loop while whole chunks fit, then the host loop.
Inside a chunk the first step of each block of ``lag`` steps (every step,
without a lag) rebuilds into the chunks' one preconditioner state, replayed
from a CUDA graph under ``use_graph``, and the chunk's steps reach the
driver together at its end. In the host loop every step is a boundary;
a build is due at its first step, then every ``lag`` steps, and at the
step after :meth:`Schedule.force_rebuild`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ndr_tpu_torch.utils import timers


def chunk_length(scan_chunk: int, lag: int) -> int:
    """Steps per chunk, a multiple of the lag; 0 (no chunked loop) when
    ``scan_chunk`` <= 1."""
    if scan_chunk <= 1:
        return 0
    return max(1, scan_chunk // lag) * lag if lag else scan_chunk


class Schedule:
    """One run's schedule. ``step_seconds``, ``cg_iters`` and
    ``cg_passes_at_cap`` get one entry per step: its wall time (in a chunk,
    the chunk's over its length), its CG iterations, and the change of the
    ``cg_passes_at_cap`` counter over it (also put in its metrics)."""

    def __init__(self, lag: int = 0, scan_chunk: int = 0):
        self.lag, self.chunk = lag, chunk_length(scan_chunk, lag)
        self.age = None  # host steps since the last build (None: none yet)
        self.step_seconds: List[float] = []
        self.cg_iters: List[int] = []
        self.cg_passes_at_cap: List[int] = []

    def force_rebuild(self) -> None:
        """Make the next host step's build due. Inside a chunk it changes
        nothing: the host loop's first step is due anyway."""
        self.age = self.lag

    def _host_due(self) -> bool:
        if not self.lag:
            return False
        due = self.age is None or self.age >= self.lag
        self.age = 1 if due else self.age + 1
        return due

    def run(self, max_iter: int, step: Callable, boundary: Callable,
            finish: Optional[Callable] = None, use_graph: bool = False) -> None:
        """Steps ``0 .. max_iter - 1``.

        ``step(precond, rebuild, use_graph) -> (metrics, precond)`` moves
        the driver's state, which stays with the driver (a first state
        held here would outlive its step): with ``rebuild`` it first
        builds the preconditioner (into ``precond``'s tensors when given;
        a chunk's builds take ``use_graph``, the host loop's never), and
        it returns the one it used. At each boundary, inside the
        ``driver.boundary`` span, ``finish(i, window)`` may turn the
        window's metrics into host numbers (and sync) before the clock is
        read; then ``boundary(i, window, dt)`` does the driver's work,
        ``i`` being the window's first step and ``dt`` each step's wall
        time."""
        i, precond = 0, None
        while self.chunk and i + self.chunk <= max_iter:
            t0 = time.perf_counter()
            window = []
            for j in range(self.chunk):
                metrics, precond = self._step(step, precond, j % (self.lag or 1) == 0,
                                              use_graph)
                window.append(metrics)
            self._boundary(i, window, t0, finish, boundary)
            i += self.chunk
        precond = None  # the host loop builds its own, without a graph
        for i in range(i, max_iter):
            t0 = time.perf_counter()
            metrics, precond = self._step(step, precond, self._host_due(), False)
            self._boundary(i, [metrics], t0, finish, boundary)

    @staticmethod
    def _step(step, precond, rebuild, use_graph):
        n0 = timers.counters.get("cg_passes_at_cap", 0)
        metrics, precond = step(precond, rebuild, use_graph)
        at_cap = timers.counters.get("cg_passes_at_cap", 0) - n0
        return dict(metrics, cg_passes_at_cap=at_cap), precond

    def _boundary(self, i, window, t0, finish, boundary):
        with timers.span("driver.boundary"):
            if finish is not None:
                window = finish(i, window)
            dt = (time.perf_counter() - t0) / len(window)
            for metrics in window:
                self.step_seconds.append(dt)
                self.cg_iters.append(int(metrics["cg_iters"]))
                self.cg_passes_at_cap.append(int(metrics["cg_passes_at_cap"]))
            boundary(i, window, dt)
