"""K-C (``csrc/lloyd_grouped.cu``, ``grouped_round_kernel``): the PQ
fit's assignment of ``B`` divisions of width ``m < 128`` at once.

The same work as K-B's (:mod:`.lloyd_round`) for ``B`` divisions of ``N``
rows and ``K`` centroids: ``2·B·N·K·m`` operations at the TF32 rate, or
the divisions' rows and centroids read once and one index a row and
division written, whichever is longer. The kernel's grouping of the
divisions in 128-wide rows is its own layout and adds nothing here.
"""

from __future__ import annotations

from .lloyd_round import least_seconds  # noqa: F401  (the same work)
