"""``serve.scan_device_ms_per_batch``: the device time of the kernels and
copies launched inside the program's ``fdb.scan`` spans (K-A over the
buckets, or the masked layout's gathers and adds) over the traced
window, over its batches, in ms (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    found = spans.of(rec)
    if found is None or "fdb.scan" not in found.names():
        return None
    return spans.per_batch_ms(
        rec, found.device_seconds("fdb.scan", rec.trace.window))
