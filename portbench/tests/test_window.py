"""Rate, time per build and the 95th percentile over a synthetic stream
of calls that holds a stall, on a clock the test drives."""

import numpy as np
import pytest

from portbench.core import Record
from portbench.spec import load_module
from portbench.window import closed_loop, percentile


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _stream(durations, seconds, items=200):
    clock = Clock()

    def call(d):
        clock.t += d
        return items, None

    def prepare(i):
        return durations[i]

    return closed_loop(prepare, call, lambda *a: None, seconds, clock=clock)


def _read(metric, win):
    return load_module("metrics", metric).read(
        Record(cell=None, window=win, setup_s=7.0))


def test_the_window_runs_past_its_seconds_to_finish_the_call_in_flight():
    durs = [0.01] * 50 + [0.5] + [0.01] * 100      # one stall of 0.5 s
    win = _stream(durs, 0.7)
    # 50 calls take 0.5 s, the stall ends at 1.0 s > 0.7: 51 calls.
    assert len(win.calls) == 51
    assert win.seconds == pytest.approx(1.0)
    assert _read("qps", win) == pytest.approx(51 * 200 / 1.0)


def test_p95_is_the_tail_of_all_batches_stall_included():
    durs = [0.010] * 95 + [0.200] * 5 + [0.010] * 10
    win = _stream(durs, sum(durs) - 0.005)        # the last call crosses
    assert len(win.calls) == len(durs)
    lat = [d * 1e3 for d in durs]
    assert _read("batch_p95_ms", win) == pytest.approx(
        np.percentile(lat, 95))
    assert percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    assert percentile([5], 95) == 5


def test_build_s_counts_the_build_in_flight():
    win = _stream([6.0, 6.0, 6.0, 9.0, 6.0], 20.0, items=1)
    # 18 s after three builds < 20: the fourth (9 s) finishes at 27 s.
    assert len(win.calls) == 4
    assert _read("build_s", win) == pytest.approx(27.0 / 4)
    assert _read("setup_s", win) == 7.0


def test_a_failed_call_ends_the_window_and_counts_as_failed():
    clock = Clock()

    def call(i):
        clock.t += 0.1
        if i == 3:
            raise RuntimeError("planted")
        return 10, None

    win = closed_loop(lambda i: i, call, lambda *a: None, 5.0, clock=clock)
    assert len(win.calls) == 4
    assert win.failed == 1 and win.items == 30
