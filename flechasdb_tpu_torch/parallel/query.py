"""Sharded IVF-PQ query on the masked layout (the JAX package's
``parallel/query.py``).

The corpus rows (PQ codes and partition indices) are row-blocked over the
mesh (:func:`.mesh.shard_corpus`). Each rank computes the coarse
top-nprobe and the ADC tables from the replicated centroids and codebooks
(``[B, P, D, C]``, the same on every rank), scans its own rows with
:func:`..ops.adc.query_masked_scan` (plain PyTorch, as the JAX package's
XLA), keeps its local top-k in global rows, and the k-best merge moves
``k`` candidates a rank (:func:`.mesh.merge_topk`). Range search gathers
every rank's key columns back into corpus-row order instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.adc import query_masked_scan, range_masked_scan
from .mesh import CorpusMesh, block_sizes, gather_blocks, merge_topk


def query_sharded(q: torch.Tensor, centroids: torch.Tensor,
                  codebooks: torch.Tensor, codes: torch.Tensor,
                  pidx: torch.Tensor,
                  row_mask: Optional[torch.Tensor] = None, *,
                  mesh: CorpusMesh, n: int, k: int, nprobe: int,
                  metric: str = "l2",
                  rotation: Optional[torch.Tensor] = None,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched k-NN with the ``n`` corpus rows blocked over ``mesh``:
    ``codes``, ``pidx`` and the optional ``row_mask`` are this rank's
    blocks (:func:`.mesh.shard_corpus`, :func:`.mesh.shard_mask`); ``q``,
    ``centroids``, ``codebooks`` and ``rotation`` the same on every rank.
    Returns :func:`..ops.adc.query_masked_scan`'s ``(distances [B, k],
    rows [B, k] int32, probed [B, nprobe] int32)``, rows global, the same
    on every rank."""
    d, rows, probed = query_masked_scan(
        q, centroids, codebooks, codes, pidx, row_mask, k=k, nprobe=nprobe,
        metric=metric, rotation=rotation)
    rows = rows + mesh.block(n)[0]
    d, rows = merge_topk(mesh, d, rows, k)
    return d, rows, probed


def range_sharded(q: torch.Tensor, centroids: torch.Tensor,
                  codebooks: torch.Tensor, codes: torch.Tensor,
                  pidx: torch.Tensor,
                  row_mask: Optional[torch.Tensor] = None, *,
                  mesh: CorpusMesh, n: int, nprobe: int, metric: str = "l2",
                  rotation: Optional[torch.Tensor] = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded range-search candidates on the masked layout, the mesh form
    of :func:`..ops.adc.range_masked_scan` with its contract: ``(keys [B,
    n], probed [B, nprobe] int32)``, column ``i`` corpus row ``i``,
    non-candidates ``+inf``, on every rank. The whole key array crosses
    the mesh: the candidate set is the result of a range search."""
    keys, probed = range_masked_scan(
        q, centroids, codebooks, codes, pidx, row_mask, nprobe=nprobe,
        metric=metric, rotation=rotation)
    return gather_blocks(mesh, keys, block_sizes(mesh, n), dim=1), probed
