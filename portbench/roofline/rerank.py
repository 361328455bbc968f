"""The exact rerank (``serving._rerank_exact``, inside the program's
``fdb.rerank`` span): each query's ``R`` best ADC candidates scored by
their exact squared L2 distance, the ``k`` best kept.

One batch of ``b`` queries reads once each candidate that holds a corpus
row (``rows`` of them: the program's ``rerank.rows``), ``4·M`` bytes a
row, the queries ``[b, M]`` and the candidates' ids and ADC keys (``b·R``
int32 and f32), and writes the ``k`` results (an f32 distance and an int32
row each). Its operations are a subtraction, a product and an add a
dimension of each row, ``3·rows·M``, at the f32 rate; the sort of ``R``
keys a query adds fewer.
"""

from __future__ import annotations

from .. import bounds, peaks


def work(*, rows: float, b: float, r: int, m: int, k: int,
         ) -> tuple[float, float, float]:
    """``(bytes read, bytes written, operations)`` of one batch."""
    read = 4.0 * (rows * m + b * m + 2 * b * r)
    return read, 8.0 * b * k, 3.0 * rows * m


def least_seconds(**shape) -> tuple[float, str]:
    read, written, ops = work(**shape)
    return bounds.bound(read + written, ops, peaks.FP32_FLOPS)
