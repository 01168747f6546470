"""The window's arithmetic: a rate is all the work over all the time,
and the window holds whole steps only."""

import pytest

from portbench import sets, window


class Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0)


def test_rate_is_all_work_over_all_time():
    # t0 = 0; steps (0, 1), (1, 3), (3, 6): the loop stops once 6 >= 5
    clock = Clock([0.0, 0.0, 1.0, 1.0, 3.0, 3.0, 6.0])
    work = iter([10.0, 30.0, 20.0])
    win = window.closed_loop(lambda i: next(work), 5.0, clock)
    assert [s[:2] for s in win.steps] == [(0.0, 1.0), (1.0, 3.0), (3.0, 6.0)]
    assert win.seconds == 6.0
    assert win.rate() == pytest.approx(60.0 / 6.0)
    # not a mean of per-step rates (10, 15, 6.67)
    assert win.rate() != pytest.approx((10.0 + 15.0 + 20.0 / 3) / 3)


def test_window_ends_on_a_whole_step():
    clock = Clock([0.0, 0.0, 0.4, 0.4, 0.8, 0.8, 1.3])
    win = window.closed_loop(lambda i: 1.0, 1.0, clock)
    assert len(win.steps) == 3 and win.t1 == 1.3 and win.work == 3.0


def test_steps_are_numbered_from_zero():
    seen = []
    clock = Clock([0.0, 0.0, 0.5, 0.5, 1.0, 1.0, 2.0])

    def step(i):
        seen.append(i)
        return 0.0

    window.closed_loop(step, 2.0, clock)
    assert seen == [0, 1, 2]


def test_spread_is_the_quartiles_over_the_median():
    # statistics.quantiles' default method: q1 = 1.5, q3 = 4.5
    assert sets.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == (4.5 - 1.5) / 3.0
