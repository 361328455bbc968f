"""``adc_scan.roofline``: K-A's share of its roofline over the traced
window: each launch's least time (``roofline/adc_scan.py``: the codes of
the rows its probed partitions hold, its tables and one key a row, at the
HBM rate) summed, over the launches' summed device time (profiler)."""

from portbench.readers import device_seconds, share
from portbench.roofline import adc_scan


def read(rec):
    work = rec.work.get("adc_scan") if rec.trace is not None else None
    if not work:
        return None
    launches = rec.trace.launches("adc_scan")
    if launches == 0:
        return None                     # K-A is off the path
    if launches != len(work):
        raise RuntimeError(f"{launches} K-A launches traced against "
                           f"{len(work)} batches")
    least = sum(adc_scan.least_seconds(**w)[0] for w in work)
    return share(least, device_seconds(rec, "adc_scan"))
