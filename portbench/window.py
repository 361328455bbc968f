"""The measured window: a closed loop of one client, each call made when
the last one's results are on the host, until ``seconds`` have passed;
the call in flight then is finished and counted. Every call's start and
end are kept, so a rate is taken over all the work and all the time of the
window, and a tail over all of its calls."""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Call:
    index: int
    start: float
    end: float
    items: int
    ok: bool


@dataclass
class Window:
    start: float
    calls: list = field(default_factory=list)

    @property
    def end(self) -> float:
        return self.calls[-1].end if self.calls else self.start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def items(self) -> int:
        return sum(c.items for c in self.calls if c.ok)

    @property
    def failed(self) -> int:
        return sum(c.items for c in self.calls if not c.ok)

    @property
    def attempted(self) -> int:
        return sum(c.items for c in self.calls)


def closed_loop(prepare: Callable, call: Callable, keep: Callable,
                seconds: float, *, wrap=None,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Runs ``call(prepare(i))`` for i = 0, 1, ... until ``seconds`` have
    passed since the window opened. ``prepare`` (the next input) and
    ``keep(i, arg, out)`` run outside each call's own interval, inside the
    window. ``call`` returns ``(items, out)``. A call that raises ends the
    window; its items count as failed. ``wrap(i)`` may give a context
    manager around each call (the traced window's spans)."""
    win = Window(start=clock())
    i = 0
    while True:
        arg = prepare(i)
        start = clock()
        try:
            if wrap is None:
                items, out = call(arg)
            else:
                with wrap(i):
                    items, out = call(arg)
            ok = True
        except Exception:                       # recorded, then the end
            traceback.print_exc(file=sys.stderr)
            items, out, ok = getattr(arg, "items", 1), None, False
        end = clock()
        win.calls.append(Call(i, start, end, items, ok))
        if not ok:
            return win
        keep(i, arg, out)
        if end - win.start >= seconds:
            return win
        i += 1


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
