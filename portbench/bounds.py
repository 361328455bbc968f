"""Least-time arithmetic: a frozen copy of ``chip_smoke.py``'s ``bound``
(``chip_smoke.py:562-572``), with the peaks taken from :mod:`.peaks`.
Times are in seconds here (the original's are in ms).
:mod:`portbench.roofline` builds each kernel's work on :func:`bound`."""

from __future__ import annotations

from . import peaks


def bound(nbytes: float, flops: float, rate: float = peaks.FP32_FLOPS,
          ops: str = "operations") -> tuple[float, str]:
    """The least time (s) for the work, and which of the two sets it:
    ``flops`` run at ``rate``, named ``ops`` when they bind."""
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = flops / rate
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, ops)

