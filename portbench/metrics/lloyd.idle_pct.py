"""``lloyd.idle_pct``: the share of the time inside the program's
``fdb.kmeans.lloyd`` spans (the Lloyd loops of the traced builds) in
which no kernel, copy or set ran on the card (``portbench/spans.py``
over the traced window's busy intervals)."""

from portbench import spans


def read(rec):
    found = spans.of(rec)
    if found is None:
        return None
    inside = found.intervals("fdb.kmeans.lloyd", rec.trace.window)
    total = sum(e - s for s, e in inside) / 1e6
    if total <= 0:
        return None
    return 100.0 * spans.idle_seconds(inside, rec.trace.busy()) / total
