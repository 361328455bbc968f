"""``bucketed.slot_fill``: the share of the bucket slots the bucketed
query scanned and sorted that hold a row: the program's
``bucketed.real_slots`` counter over its ``bucketed.slots``, both counted
while the profiler collected (the traced windows), in %."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from flechasdb_tpu_torch.utils.profiling import counters
    except ImportError:
        return None                     # a program without counters
    got = counters()
    slots = got.get("bucketed.slots", 0)
    if slots <= 0:
        return None
    return 100.0 * got.get("bucketed.real_slots", 0) / slots
