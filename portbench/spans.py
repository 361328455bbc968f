"""The program's ``fdb.`` spans in a traced window, and the device work
each one launched, read back from the run's Chrome trace.

A span is a ``user_annotation`` on the host thread that entered it. The
card runs a kernel, copy or set after the CUDA API call that launched it,
often after the span has closed; the trace pairs the two by their
``correlation`` id. Each device op is credited to the innermost
``fdb.`` span that was open on the launching thread when the launch
began, or to none. :func:`of` reads a run's trace once and keeps it for
the other readers of the same file.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .tracing import trace_path

PREFIX = "fdb."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Spans:
    #: ``(name, start_us, end_us)`` of every ``fdb.`` span, by start.
    spans: list
    #: ``(start_us, dur_us, span)`` of every device op, by start; ``span``
    #: the name of the span its launch lies in, or ``None``.
    ops: list

    def names(self) -> set:
        return {s[0] for s in self.spans}

    def intervals(self, name: str, window: tuple) -> list:
        """``[start, end)`` of the spans named ``name``, cut to
        ``window``, merged."""
        a0, a1 = window
        out = []
        for n, s, e in self.spans:
            s, e = max(s, a0), min(e, a1)
            if n != name or e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def span_seconds(self, name: str, window: tuple) -> float:
        """The summed duration of the spans named ``name`` that start in
        ``window``."""
        a0, a1 = window
        return sum(e - s for n, s, e in self.spans
                   if n == name and a0 <= s <= a1) / 1e6

    def device_seconds(self, name: str, window: tuple) -> float:
        """The device time of the ops launched in a span named ``name``
        that start in ``window``."""
        a0, a1 = window
        return sum(d for s, d, span in self.ops
                   if span == name and a0 <= s <= a1) / 1e6


def _credit(launches: list, spans: dict) -> dict:
    """``{correlation: span name}`` for ``launches`` ``[(thread, ts,
    correlation)]``, each to the innermost span of ``spans`` ``{thread:
    [(start, end, name)]}`` open at its ``ts``. Spans of one thread
    nest, so a sweep in time order with a stack of the open ones finds
    it."""
    by_thread = defaultdict(list)
    for thread, ts, corr in launches:
        by_thread[thread].append((ts, corr))
    out = {}
    for thread, items in by_thread.items():
        opened = sorted(spans.get(thread, []), key=lambda s: (s[0], -s[1]))
        stack, i = [], 0
        for ts, corr in sorted(items):
            while i < len(opened) and opened[i][0] <= ts:
                while stack and stack[-1][1] < opened[i][0]:
                    stack.pop()                 # closed before it opened
                stack.append(opened[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            if stack:
                out[corr] = stack[-1][2]
    return out


def parse(path: Path) -> Spans:
    """The ``fdb.`` spans and the credited device ops of the Chrome trace
    at ``path``."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    spans, by_thread, launches, device = [], defaultdict(list), [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        thread = (ev.get("pid"), ev.get("tid"))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name, ts, ts + dur))
            by_thread[thread].append((ts, ts + dur, name))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches.append((thread, ts, corr))
        elif cat in _DEVICE_CATS:
            device.append((ts, dur, corr))
    credit = _credit(launches, by_thread)
    ops = sorted((ts, dur, credit.get(corr)) for ts, dur, corr in device)
    return Spans(sorted(spans, key=lambda s: s[1]), ops)


_CACHE: dict = {}


def of(rec) -> Optional[Spans]:
    """The spans of a traced run's trace (the file its ``rec.trace`` came
    from), or ``None`` for an untraced run or a trace with no ``fdb.``
    span (a program without them)."""
    if rec.trace is None:
        return None
    path = trace_path(rec.cell.name)
    try:
        st = path.stat()
    except OSError:
        return None
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = parse(path)
    found = _CACHE[key]
    return found if found.spans else None


def idle_seconds(intervals: list, busy: list) -> float:
    """The time in the merged ``intervals`` that the merged ``busy``
    intervals leave uncovered, in seconds."""
    idle, j = 0.0, 0
    for s, e in intervals:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle / 1e6


def per_batch_ms(rec, seconds: float) -> Optional[float]:
    """``seconds`` over the window's batches, in ms; ``None`` at 0."""
    calls = len(rec.window.calls)
    return 1e3 * seconds / calls if calls and seconds > 0 else None
