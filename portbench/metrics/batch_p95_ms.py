"""``batch_p95_ms``: the 95th percentile of the latencies of all the
window's batches, each from the call to its results on the host."""

from portbench.window import percentile


def read(rec):
    lat = [(c.end - c.start) * 1e3 for c in rec.window.calls if c.ok]
    return percentile(lat, 95.0) if lat else None
