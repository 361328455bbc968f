"""Sharded pruned (bucketed) IVF-PQ query (the JAX package's
``parallel/bucketed.py``).

The :class:`..ops.bucketed.Buckets` arrays are split on the partition
axis (:func:`shard_buckets`): rank ``r`` holds partitions ``[r·Pl,
(r+1)·Pl)``, the last blocks padded with empty partitions. A query runs
the single-device query over the rank's block (``ops.bucketed``'s
``_query_block``), which

1. computes the coarse top-nprobe and the probed ADC tables on every rank
   from the replicated centroids (the same on each, no communication),
2. scans the probed buckets this rank owns with kernel K-A, in place; a
   probe slot another rank owns takes length 0, so K-A writes ``+inf``
   there and reads no codes,
3. keeps a local top-k in global corpus rows (bucket slots hold the
   original row numbers);

then the ranks merge ``k`` candidates each (:func:`.mesh.merge_topk`).

Range search keeps every probe slot's candidates, each from the rank that
owns its partition: the slot's rows and keys are that rank's, so a slot
is kept by its owner, its length and the row mask, as
:func:`..ops.bucketed.range_bucketed` keeps it, never by whether its key
is finite (an ADC key may overflow to ``+inf`` on a kept row).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.bucketed import Buckets, _query_block, _range_block
from ..utils.profiling import annotate
from .mesh import CorpusMesh, all_gather, merge_topk


def shard_buckets(mesh: CorpusMesh, buckets: Buckets) -> Buckets:
    """This rank's block of ``Pl = ceil(P / size)`` partitions of a
    bucketed layout (host or device arrays), on the mesh's device; ``P``
    pads to ``size·Pl`` with empty partitions (length 0, rows ``-1``),
    so every rank holds ``[Pl, ·, L]``."""
    codes, rows, lens = (torch.as_tensor(t) for t in buckets)
    p = codes.shape[0]
    pl = -(-p // mesh.size)
    a, z = mesh.rank * pl, (mesh.rank + 1) * pl
    pad = max(0, z - max(a, p))

    def block(t, fill):
        part = t[min(a, p):min(z, p)].to(mesh.device)
        if pad:
            part = torch.cat([part, torch.full((pad, *t.shape[1:]), fill,
                                               dtype=t.dtype,
                                               device=mesh.device)])
        return part.contiguous()

    return Buckets(block(codes, 0), block(rows, -1), block(lens, 0))


def query_bucketed_sharded(q: torch.Tensor, centroids: torch.Tensor,
                           codebooks: torch.Tensor, buckets: Buckets,
                           row_mask: Optional[torch.Tensor] = None, *,
                           mesh: CorpusMesh, k: int, nprobe: int,
                           metric: str = "l2",
                           rotation: Optional[torch.Tensor] = None,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Batched pruned k-NN with ``buckets`` this rank's block
    (:func:`shard_buckets`): :func:`..ops.bucketed.query_bucketed`'s
    ``(distances [B, k], rows [B, k] int32, probed [B, nprobe] int32)``
    on every rank. ``row_mask [N] bool`` is over global corpus rows, the
    same on every rank."""
    dist, rows, probed = _query_block(
        q, centroids, codebooks, buckets, row_mask,
        mesh.rank * buckets.codes.shape[0], k=k, nprobe=nprobe,
        metric=metric, rotation=rotation)
    with annotate("fdb.topk"):
        dist, rows = merge_topk(mesh, dist, rows, k)
    return dist, rows, probed


def range_bucketed_sharded(q: torch.Tensor, centroids: torch.Tensor,
                           codebooks: torch.Tensor, buckets: Buckets,
                           row_mask: Optional[torch.Tensor] = None, *,
                           mesh: CorpusMesh, nprobe: int, metric: str = "l2",
                           rotation: Optional[torch.Tensor] = None,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Sharded range-search candidates, the mesh form of
    :func:`..ops.bucketed.range_bucketed` with its contract: ``(keys [B,
    nprobe·L], rows [B, nprobe·L] int32, probed [B, nprobe] int32)`` in
    probe order, then slot; pad slots and filtered rows ``+inf`` and row
    ``-1``; on every rank. Each probe slot's keys and rows are copied
    from the rank that owns its partition. The whole candidate array
    crosses the mesh: it is the result of a range search."""
    pl, _, l = buckets.codes.shape
    keys, rows, probed = _range_block(
        q, centroids, codebooks, buckets, row_mask, mesh.rank * pl,
        nprobe=nprobe, metric=metric, rotation=rotation)
    # The owner of each probe's partition, the same on every rank.
    owner = (probed.long() // pl).repeat_interleave(l, dim=1)[None]
    keys = torch.stack(all_gather(mesh, keys)).gather(0, owner)[0]
    rows = torch.stack(all_gather(mesh, rows)).gather(0, owner)[0]
    return keys, rows, probed
