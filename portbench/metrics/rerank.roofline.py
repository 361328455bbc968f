"""``rerank.roofline``: the exact rerank's share of its roofline over the
traced window: the least time (``roofline/rerank.py``) of the candidate
rows the program's ``rerank.rows`` counter counted, a batch at a time,
over the device time of the ops launched inside its ``fdb.rerank`` spans
(``portbench/spans.py``). Nothing where the program has no such
counter."""

from portbench import counted, spans
from portbench.readers import share
from portbench.roofline import rerank


def read(rec):
    got = counted.in_window(rec, "rerank.rows")
    found = spans.of(rec)
    if got is None or found is None:
        return None
    cfg, calls = rec.cell.config, len(rec.window.calls)
    least = calls * rerank.least_seconds(
        rows=got["rerank.rows"] / calls, b=rec.window.attempted / calls,
        r=cfg["rerank"], m=cfg["dim"], k=cfg["k"])[0]
    return share(least, found.device_seconds("fdb.rerank",
                                             rec.trace.window))
