"""The ADC tables step (``ops/bucketed.probed_tables``, inside the
program's ``fdb.tables`` span): the L2 table ``[D, C]`` f32 of each
(query, probed partition) cell of a batch.

One batch of ``b`` queries and ``cells`` cells writes each table once,
``4·cells·D·C`` bytes, and reads once the probed centroids (a partition's
at most once: ``min(cells, P)`` rows of ``M`` floats), the queries ``[b,
M]`` and the codebooks ``[D, C, M/D]``. Its operations are each residual's
products with every codeword, ``2·cells·C·M``, at the f32 rate (the
configurations state no TF32); the norms and the clamp add fewer.
"""

from __future__ import annotations

from .. import bounds, peaks


def work(*, cells: float, b: float, p: int, m: int, d: int, c: int,
         ) -> tuple[float, float, float]:
    """``(bytes read, bytes written, operations)`` of one batch."""
    read = 4.0 * (min(cells, p) * m + b * m + c * m)
    return read, 4.0 * cells * d * c, 2.0 * cells * c * m


def least_seconds(**shape) -> tuple[float, str]:
    read, written, ops = work(**shape)
    return bounds.bound(read + written, ops, peaks.FP32_FLOPS)
