"""The measured window and its arithmetic.

A closed loop runs whole steps back to back until the window's seconds
have passed; the window ends with the last step, so every step counted
lies wholly inside it and none is cut.  A rate is all the work of the
window over all of its time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Window:
    t0: float
    t1: float
    steps: list = field(default_factory=list)  # (start, end, work)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def work(self) -> float:
        return sum(w for _, _, w in self.steps)

    def rate(self) -> float:
        """All the work of the window over all of its time."""
        return self.work / self.seconds


def closed_loop(step, seconds: float, clock=time.perf_counter) -> Window:
    """Call ``step(i)`` (which returns its work once its results are on
    the host) for i = 0, 1, ... until ``seconds`` have passed."""
    t0 = clock()
    win = Window(t0=t0, t1=t0)
    i = 0
    while True:
        a = clock()
        work = step(i)
        b = clock()
        win.steps.append((a, b, work))
        win.t1 = b
        i += 1
        if b - t0 >= seconds:
            return win
