"""``serve.topk_device_ms_per_batch``: the device time of the kernels and
copies launched inside the program's ``fdb.topk`` spans (the top-k sort
and its index arithmetic) over the traced window, over its batches, in
ms (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    found = spans.of(rec)
    if found is None or "fdb.topk" not in found.names():
        return None
    return spans.per_batch_ms(
        rec, found.device_seconds("fdb.topk", rec.trace.window))
