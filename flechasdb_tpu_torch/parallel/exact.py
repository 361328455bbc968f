"""Sharded exact (flat) k-NN (the JAX package's ``parallel/exact.py``).

The raw corpus rows are row-blocked over the mesh (:func:`shard_flat`);
each rank runs :func:`..ops.exact.exact_topk` (cuBLAS in full f32) on its
own rows, offsets them to global rows, and the k-best merge moves ``k``
candidates a rank, the lower row first among equal keys
(:func:`.mesh.merge_topk`). Blocks hold only real rows, so no pad row can
win a slot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.distance import full_f32
from ..ops.exact import exact_keys, exact_topk
from .mesh import CorpusMesh, block_sizes, gather_blocks, merge_topk, \
    sum_ranks


def shard_flat(mesh: CorpusMesh, x) -> tuple[torch.Tensor, int]:
    """This rank's block of the corpus ``x [N, M]``, f32 on the mesh's
    device, and ``N``."""
    a, z = mesh.block(len(x))
    return (torch.as_tensor(np.asarray(x[a:z], np.float32),
                            device=mesh.device), len(x))


def exact_sharded(q: torch.Tensor, x: torch.Tensor,
                  row_mask: Optional[torch.Tensor] = None, *,
                  mesh: CorpusMesh, k: int, n: int, metric: str = "l2",
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN with the ``n`` corpus rows blocked over ``mesh``: ``x``
    and the optional ``row_mask`` are this rank's blocks
    (:func:`shard_flat`, :func:`.mesh.shard_mask`). Returns ``(keys [B,
    k], rows [B, k] int32)`` on every rank, ``+inf`` past the reachable
    rows; keys as :func:`..ops.exact.exact_keys` ranks them."""
    d, rows = exact_topk(q, x, row_mask, k=k, metric=metric)
    return merge_topk(mesh, d, rows + mesh.block(n)[0], k)


@full_f32()
def rerank_sharded(q: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                   x: torch.Tensor, *, mesh: CorpusMesh, k: int, n: int,
                   metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of ADC candidates against the blocked corpus, the
    mesh form of the in-memory rerank (``serving._rerank_exact``): ``q [B,
    M]``, candidate global ``rows [B, R]``, ``valid [B, R]`` (False where
    the ADC pass ran dry), ``x`` this rank's block. Each candidate's exact
    key comes from the rank that owns its row, the others adding exact
    zeros (:func:`.mesh.sum_ranks`): only the ``[B, R]`` keys cross the
    mesh. Returns ``(keys [B, k], rows [B, k])`` on every rank, a stable
    ascending sort's order."""
    a, z = mesh.block(n)
    local = rows.long() - a
    owned = valid & (local >= 0) & (local < z - a)
    if z > a:
        cand = x[torch.where(owned, local, 0)]                 # [B, R, M]
        if metric == "dot":
            exact = -torch.bmm(cand, q[:, :, None])[..., 0]
        else:
            diff = cand - q[:, None, :]
            exact = (diff * diff).sum(dim=-1)
        exact = exact.masked_fill(~owned, 0.0)
    else:
        exact = torch.zeros(rows.shape, device=q.device)
    exact = sum_ranks(mesh, exact).masked_fill_(~valid, float("inf"))
    best = torch.sort(exact, dim=1, stable=True)
    return best.values[:, :k], rows.gather(1, best.indices[:, :k])


def exact_keys_sharded(q: torch.Tensor, x: torch.Tensor, *,
                       mesh: CorpusMesh, n: int, metric: str = "l2",
                       ) -> torch.Tensor:
    """Exact ranking keys of every corpus row (the flat tier's range
    search), ``x`` this rank's block: ``[B, n]`` on every rank, column
    ``i`` corpus row ``i``. The whole key array crosses the mesh."""
    return gather_blocks(mesh, exact_keys(q, x, metric),
                         block_sizes(mesh, n), dim=1)
