"""IVF coarse partitioning with residues (the JAX package's
``partitions.py``, ``partitions.rs:96-144``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .events import EventHandler, _noop
from .ops import kmeans


class Partitions(NamedTuple):
    """``centroids [P, M]``, ``indices [N]`` int32 partition a vector,
    ``residues [N, M]`` = vector − its centroid."""
    centroids: torch.Tensor
    indices: torch.Tensor
    residues: torch.Tensor

    def reconstruct(self, i: int | torch.Tensor) -> torch.Tensor:
        """Original vector(s): residue + centroid (``partitions.rs:68-93``).
        """
        return self.residues[i] + self.centroids[self.indices[i].long()]


def partition(x: torch.Tensor, p: int, generator: torch.Generator,
              events: EventHandler = _noop,
              epsilon: float = kmeans.DEFAULT_EPSILON,
              impl: str | None = None) -> Partitions:
    """Clusters ``x [N, M]`` into ``p`` partitions and computes residues.
    ``epsilon`` is the fit's convergence threshold; ``impl`` selects the
    Lloyd round's kernel and numerics, as in :func:`.ops.kmeans.fit`
    (e.g. ``"_fast"``: the auto kernel with ``fast_math`` numerics)."""
    res = kmeans.fit(x[None], p, generator, epsilon=epsilon, handler=events,
                     impl=impl)
    centroids, indices = res.centroids[0], res.indices[0]
    return Partitions(centroids, indices, x - centroids[indices.long()])
