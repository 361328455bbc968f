"""K-B (``csrc/lloyd_round.cu``, ``assign_kernel``): a Lloyd round's
assignment of ``x [B, N, M]`` to ``K`` centroids.

Its least work is ``2·B·N·K·M`` operations at the TF32 tensor-core rate
(the kernel's 3xTF32 product is counted once), or reading x and the
centroids with their norms once and writing one index a row at the HBM
rate, whichever is longer. The sums that follow are the pass's
(:mod:`.cluster_sums`).
"""

from __future__ import annotations

from .. import bounds, peaks


def least_seconds(*, b: int, n: int, k: int, m: int) -> tuple[float, str]:
    nbytes = 4 * (b * n * m + b * k * m + b * k + b * n)
    return bounds.bound(nbytes, 2.0 * b * n * k * m, peaks.TF32_FLOPS,
                        "ops, TF32")
