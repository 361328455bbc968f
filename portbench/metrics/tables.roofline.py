"""``tables.roofline``: the ADC tables step's share of its roofline over
the traced window: the least time (``roofline/tables.py``) of the tables
the program's ``tables.cells`` counter counted, a batch at a time, over
the device time of the ops launched inside its ``fdb.tables`` spans
(``portbench/spans.py``). Nothing where the program has no such
counter."""

from portbench import counted, spans
from portbench.readers import share
from portbench.roofline import tables


def read(rec):
    got = counted.in_window(rec, "tables.cells")
    found = spans.of(rec)
    if got is None or found is None:
        return None
    cfg, calls = rec.cell.config, len(rec.window.calls)
    least = calls * tables.least_seconds(
        cells=got["tables.cells"] / calls, b=rec.window.attempted / calls,
        p=cfg["partitions"], m=cfg["dim"], d=cfg["divisions"],
        c=cfg["clusters"])[0]
    return share(least, found.device_seconds("fdb.tables",
                                             rec.trace.window))
