"""The cluster-sum pass (``csrc/cluster_sums.cu``: ``tile_sums`` and
``combine_tiles``, or the sort route's six kernels) that follows each K-B
and K-C round.

Bound by bytes: ``x [B, N, m]`` and the assignment ``[B, N]`` read once,
the sums ``[B, K, m]`` and counts ``[B, K]`` written once; its ``B·N·m``
adds run far below the f32 rate.
"""

from __future__ import annotations

from .. import bounds, peaks


def least_seconds(*, b: int, n: int, k: int, m: int) -> tuple[float, str]:
    nbytes = 4 * (b * n * m + b * n + b * k * m + b * k)
    return bounds.bound(nbytes, float(b * n * m), peaks.FP32_FLOPS)
