"""``serve.results_ms_per_batch``: the host time of the program's
``fdb.results`` spans (``Database.query_batch`` making its
``QueryResult`` lists) over the traced window, over its batches, in ms
(``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    found = spans.of(rec)
    if found is None or "fdb.results" not in found.names():
        return None
    return spans.per_batch_ms(
        rec, found.span_seconds("fdb.results", rec.trace.window))
