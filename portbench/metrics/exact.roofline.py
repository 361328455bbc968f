"""``exact.roofline``: the exact scan's share of its roofline over the
traced window: the least time (``roofline/exact.py``) of the pairs the
program's ``exact.pairs`` counter counted, a batch at a time, over the
device time of the ops launched inside its ``fdb.exact`` spans
(``portbench/spans.py``). Nothing where the program has no such counter.

A counter counts every call made while a profiler collected, those of
any window ``tracing.traced`` profiled and threw away too; the scan's own
``exact.queries`` counts their queries, so both counters are scaled by
the share of them that the kept window asked (as ``counted.py`` does with
the bucketed top-k's)."""

from portbench import spans
from portbench.readers import share
from portbench.roofline import exact


def read(rec):
    if rec.trace is None or not rec.window.calls:
        return None
    try:
        from flechasdb_tpu_torch.utils.profiling import counters
    except ImportError:
        return None                     # a program without counters
    got = counters()
    queries, pairs = got.get("exact.queries", 0), got.get("exact.pairs", 0)
    found = spans.of(rec)
    if queries <= 0 or pairs <= 0 or found is None:
        return None
    asked = rec.window.attempted
    scale = asked / queries if queries > asked else 1.0
    calls = len(rec.window.calls)
    cfg = rec.cell.config
    least = calls * exact.least_seconds(
        pairs=pairs * scale / calls, b=queries * scale / calls,
        m=cfg["dim"], k=cfg["k"])[0]
    return share(least, found.device_seconds("fdb.exact", rec.trace.window))
