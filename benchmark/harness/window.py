"""The measured window, decided at the boundaries of the program's loop.

A boundary is where the program hands control back: after every step of a
host loop, after every chunk of a chunked one. The window opens at the
first boundary after the warm-up steps and closes at the last boundary
before which one more interval, as long as the longest one so far, would
pass the run's seconds. So it always holds whole intervals (whole chunks),
and at a steady pace it never passes the seconds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Interval:
    seconds: float
    steps: int
    failed: int


class Window:
    """Feed it each boundary's clock reading and step count in order."""

    def __init__(self, seconds: float, warm_steps: int):
        if seconds <= 0:
            raise ValueError("the window needs a positive length")
        self.seconds = float(seconds)
        self.warm_steps = int(warm_steps)
        self.t_open: Optional[float] = None
        self.steps_open = 0
        self.t_close: Optional[float] = None
        self.intervals: List[Interval] = []
        self._t_prev: Optional[float] = None
        self._steps_prev = 0
        self._warm_interval = 0.0

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    def boundary(self, t: float, steps: int, at_cap: int = 0, nonfinite: int = 0) -> bool:
        """Take one boundary: ``steps`` done so far; ``at_cap`` CG passes
        that stopped at their cap and ``nonfinite`` steps with a
        non-finite objective since the last boundary. Returns True when
        the window closes here."""
        if self.closed:
            raise RuntimeError("the window has closed")
        if steps <= self._steps_prev and self._t_prev is not None:
            raise ValueError("a boundary must follow at least one step")
        dt = None if self._t_prev is None else t - self._t_prev
        n = steps - self._steps_prev
        self._t_prev, self._steps_prev = t, steps
        if self.t_open is None:
            if dt is not None:
                self._warm_interval = dt
            if steps < self.warm_steps:
                return False
            if self._warm_interval > self.seconds:
                raise RuntimeError(
                    f"one interval takes {self._warm_interval:.3f} s, more than the "
                    f"{self.seconds:.3f} s window")
            self.t_open, self.steps_open = t, steps
            return False
        self.intervals.append(Interval(dt, n, min(n, at_cap + nonfinite)))
        if dt > self.seconds:
            raise RuntimeError(
                f"one interval took {dt:.3f} s, more than the {self.seconds:.3f} s window")
        longest = max(iv.seconds for iv in self.intervals)
        if (t - self.t_open) + longest > self.seconds:
            self.t_close = t
            return True
        return False

    @property
    def steps(self) -> int:
        return sum(iv.steps for iv in self.intervals)

    @property
    def failed(self) -> int:
        return sum(iv.failed for iv in self.intervals)

    @property
    def wall(self) -> float:
        return (self.t_close if self.t_close is not None else self._t_prev) - self.t_open

    @property
    def step_seconds(self) -> float:
        """The window's wall time over the steps completed in it."""
        return self.wall / self.steps
