"""The exact scan (``ops/exact.exact_topk``, inside the program's
``fdb.exact`` span): every query of a batch scored against every corpus
row, the ``k`` best kept.

One batch of ``b`` queries scores ``pairs`` (query, row) pairs (the
program's ``exact.pairs``: ``b·N``). Its least work reads the corpus once,
``4·N·M`` bytes (``N = pairs / b``), and the queries, ``4·b·M``, and
writes the ``k`` results, an f32 distance and an int32 row each,
``8·b·k``. Its operations are the cross term's product, ``2·pairs·M``;
the norms, the adds and the fold add fewer.

The operations run at the TF32 tensor-core rate although the
configuration states f32: a product as accurate as f32 may run on the
tensor cores as split TF32 (as K-B's 3xTF32 does), and a kernel that did
so could pass a bound set at the f32 units' rate, a share above 100% that
would read as an impossible gain. At the f32 units' rate the same work
takes 7.4 times as long (3.8 ms for a batch of 1000 over 1M rows of 128).
"""

from __future__ import annotations

from .. import bounds, peaks


def work(*, pairs: float, b: float, m: int, k: int,
         ) -> tuple[float, float, float]:
    """``(bytes read, bytes written, operations)`` of one batch."""
    read = 4.0 * (pairs / b * m + b * m)
    return read, 8.0 * b * k, 2.0 * pairs * m


def least_seconds(**shape) -> tuple[float, str]:
    read, written, ops = work(**shape)
    return bounds.bound(read + written, ops, peaks.TF32_FLOPS, "ops, TF32")
