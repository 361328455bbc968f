"""The program's counters (``flechasdb_tpu_torch.utils.profiling``) over
a traced run's window.

A counter counts every call made while a profiler collected: the traced
window's, and those of any window ``tracing.traced`` profiled before it
and threw away. The bucketed top-k's own counters count those calls'
queries, so each counter is scaled by the share of them that the kept
window asked.
"""

from __future__ import annotations

from typing import Optional

#: The bucketed top-k's counters: together, the queries it answered.
QUERIES = ("bucketed.topk_kernel", "bucketed.topk_sort")


def in_window(rec, *names: str) -> Optional[dict]:
    """``{name: count}`` over the traced window of ``rec`` for each of
    ``names``; ``None`` for an untraced run or where a counter is absent
    (a program without it)."""
    if rec.trace is None or not rec.window.calls:
        return None
    try:
        from flechasdb_tpu_torch.utils.profiling import counters
    except ImportError:
        return None                     # a program without counters
    got = counters()
    if any(got.get(n, 0) <= 0 for n in names):
        return None
    asked = sum(got.get(n, 0) for n in QUERIES)
    scale = rec.window.attempted / asked if asked > rec.window.attempted \
        else 1.0
    return {n: got[n] * scale for n in names}
