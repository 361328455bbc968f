"""``serve.device_ms_per_batch``: the device time of the traced window's
kernels and copies (``torch.profiler``) over its batches, in ms."""


def read(rec):
    if rec.trace is None or not rec.window.calls:
        return None
    a0, a1 = rec.trace.window
    busy = sum(d for _, s, d in rec.trace.kernels if a0 <= s <= a1) / 1e3
    return busy / len(rec.window.calls) if busy > 0 else None
