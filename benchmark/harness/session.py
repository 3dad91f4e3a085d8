"""One run of the program's entry, as the harness sees it: the log lines
the entry writes, the clock at each boundary of its loop, the window, the
solver's counters, and the traced stretch that follows the window in a
``--trace 1`` run. The harness stops the entry by raising :class:`Stop`
from the entry's own callback."""

from __future__ import annotations

import math
import re
import time
from typing import Dict, Optional

from benchmark.harness.window import Window

_STEP = re.compile(r"Total Steps: (\d+),.*?Compliance loss (\S+?),(?:.*?\bloss (\S+?),)?"
                   r".*?cg_iters (\d+)")


class Stop(Exception):
    """Raised from the program's callback to end its run."""


def _float(s: Optional[str]) -> Optional[float]:
    return None if s is None else float(s)


class StepLog:
    """The per-step lines the entry logs (``log_every=1``): the objective,
    the loss where given, and the CG iterations of each step, by step index
    (the logged number less ``first``)."""

    def __init__(self, first: int = 0):
        self.first = first
        self.steps: Dict[int, dict] = {}

    def __call__(self, line: str) -> None:
        m = _STEP.search(line)
        if m is None:
            return
        c = _float(m.group(2))
        loss = _float(m.group(3))
        self.steps[int(m.group(1)) - self.first] = {
            "compliance": c, "loss": c if loss is None else loss,
            "cg_iters": int(m.group(4))}

    def nonfinite(self, lo: int, hi: int) -> int:
        return sum(1 for k in range(lo, hi)
                   if k in self.steps and not math.isfinite(self.steps[k]["compliance"]))

    def cg_iters(self, lo: int, hi: int) -> int:
        missing = [k for k in range(lo, hi) if k not in self.steps]
        if missing:
            raise RuntimeError(f"no log line for steps {missing[:5]}")
        return sum(self.steps[k]["cg_iters"] for k in range(lo, hi))


class Session:
    """Clock, window and trace of one run.

    ``stats``: the solver's counter dict (read, never written). ``trace``:
    how many boundaries the traced stretch after the window spans (0: no
    trace). ``profiler``: a callable that returns a started profiler.
    """

    def __init__(self, seconds: float, warm_steps: int, stats: dict, log: StepLog,
                 trace: int = 0, profiler=None, sync=lambda: None,
                 memory_peak=lambda: 0):
        self.window = Window(seconds, warm_steps)
        self.stats, self.log = stats, log
        self.trace_left, self.profiler, self.sync = trace, profiler, sync
        self.memory_peak = memory_peak
        self.phase = "warm"       # warm, window, trace, done
        self.steps = 0
        self.stats_open: Dict[str, float] = {}
        self.stats_close: Dict[str, float] = {}
        self.peak_bytes = 0
        self.prof = None
        self.trace_seconds = 0.0
        self.trace_steps = 0
        self.t_first = None       # the clock at the first boundary
        self._cap = stats.get("cg_passes_at_cap", 0)
        self._t_trace = 0.0
        self._steps_trace = 0

    def boundary(self, steps: int) -> str:
        """Take the boundary after ``steps`` steps in all. Returns the phase
        the steps just finished belong to: "warm", "window" or "trace"."""
        t = time.perf_counter()
        if self.t_first is None:
            self.t_first = t
        prev, self.steps = self.steps, steps
        cap = self.stats.get("cg_passes_at_cap", 0)
        at_cap, self._cap = cap - self._cap, cap
        phase = self.phase
        if phase == "warm":
            self.window.boundary(t, steps)
            if self.window.is_open:
                self.phase = "window"
                self.stats_open = dict(self.stats)
        elif phase == "window":
            if self.window.boundary(t, steps, at_cap, self.log.nonfinite(prev, steps)):
                self.stats_close = dict(self.stats)
                self.peak_bytes = self.memory_peak()
                self.phase = "trace" if self.trace_left else "done"
                if self.trace_left:
                    self.sync()
                    self.prof = self.profiler()
                    self._t_trace, self._steps_trace = time.perf_counter(), steps
        elif phase == "trace":
            self.trace_left -= 1
            if self.trace_left == 0:
                self.sync()
                self.prof.stop()
                self.trace_seconds = time.perf_counter() - self._t_trace
                self.trace_steps = steps - self._steps_trace
                self.phase = "done"
        return phase

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def check(self) -> None:
        """Raise :class:`Stop` once the run has what it needs."""
        if self.done:
            raise Stop()

    @property
    def window_steps(self):
        """(first, last + 1) step index of the window."""
        return self.window.steps_open, self.window.steps_open + self.window.steps

    def counters(self) -> dict:
        """The window's counts for the per-layer readers."""
        lo, hi = self.window_steps
        delta = {k: self.stats_close[k] - self.stats_open.get(k, 0)
                 for k in self.stats_close}
        return {"steps": self.window.steps,
                "cg_iters": self.log.cg_iters(lo, hi),
                "stats_window": delta,
                "stats_total": dict(self.stats_close)}
