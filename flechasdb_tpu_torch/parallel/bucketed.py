"""Sharded pruned (bucketed) IVF-PQ query (the JAX package's
``parallel/bucketed.py``).

The :class:`..ops.bucketed.Buckets` arrays are split on the partition
axis (:func:`shard_buckets`): rank ``r`` holds partitions ``[r·Pl,
(r+1)·Pl)``, the last blocks padded with empty partitions. A query:

1. computes the coarse top-nprobe and the probed ADC tables on every rank
   from the replicated centroids (the same on each, no communication),
2. scans the probed buckets this rank owns with kernel K-A, in place; a
   probe slot another rank owns takes length 0, so K-A writes ``+inf``
   there and reads no codes,
3. keeps a local top-k in global corpus rows (bucket slots hold the
   original row numbers),
4. merges ``k`` candidates a rank (:func:`.mesh.merge_topk`).

Range search keeps every probe slot's candidates, each from the rank that
owns its partition: the slot's rows and keys are that rank's, so a slot
is kept by its owner, its length and the row mask, as
:func:`..ops.bucketed.range_bucketed` keeps it, never by whether its key
is finite (an ADC key may overflow to ``+inf`` on a kept row).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.adc import coarse_scores
from ..ops.bucketed import Buckets, _kept, probed_tables, topk_rows
from ..ops.scan import adc_lookup_indexed
from ..utils.profiling import annotate, count
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


def _owned_scan(q: torch.Tensor, centroids: torch.Tensor,
                codebooks: torch.Tensor, local: Buckets, mesh: CorpusMesh,
                nprobe: int, metric: str, rotation: Optional[torch.Tensor],
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Steps 1 and 2: ``(vdist [B, nprobe, L], slot [B, nprobe], probed
    [B, nprobe], bidx [B·nprobe] int32, lens [B·nprobe] int32)``; ``slot``
    is the local bucket of an owned probe (0 elsewhere), ``bidx`` and
    ``lens`` the flat buckets and lengths K-A takes (0 where unowned), and
    K-A writes ``+inf`` past each owned bucket's length and over every
    unowned slot."""
    b = q.shape[0]
    d, c, _ = codebooks.shape
    pl, _, l = local.codes.shape
    with annotate("fdb.probe"):
        coarse = coarse_scores(q, centroids, metric)         # [B, P]
        probed = torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]
        lidx = probed - mesh.rank * pl
        owned = (lidx >= 0) & (lidx < pl)
        slot = torch.where(owned, lidx, 0)
        lens = torch.where(owned, local.lengths[slot], 0)
    with annotate("fdb.tables"):
        count("tables.cells", b * nprobe)
        tables = probed_tables(q, centroids, codebooks, probed, metric,
                               coarse, rotation)
    with annotate("fdb.scan"):
        bidx = slot.reshape(-1).to(torch.int32).contiguous()
        lens = lens.reshape(-1).to(torch.int32).contiguous()
        vdist = adc_lookup_indexed(
            local.codes, tables.reshape(b * nprobe, d * c).contiguous(),
            bidx, lens, d=d)
        return vdist.reshape(b, nprobe, l), slot, probed, bidx, lens


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
    vdist, slot, probed, bidx, lens = _owned_scan(
        q, centroids, codebooks, buckets, mesh, nprobe, metric, rotation)
    if row_mask is not None:
        with annotate("fdb.scan"):
            vdist = vdist.masked_fill(
                ~_kept(buckets.rows[slot], row_mask), float("inf"))
    with annotate("fdb.topk"):
        dist, rows = topk_rows(vdist, lens, bidx, buckets.rows, k=k)
        dist, rows = merge_topk(mesh, dist, rows, k)
        return dist, rows, probed.to(torch.int32)


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
    b = q.shape[0]
    pl, _, l = buckets.codes.shape
    vdist, slot, probed, _, _ = _owned_scan(
        q, centroids, codebooks, buckets, mesh, nprobe, metric, rotation)
    rows = buckets.rows[slot]                                # [B, nprobe, L]
    if row_mask is not None:
        drop = ~_kept(rows, row_mask)
        vdist = vdist.masked_fill(drop, float("inf"))
        rows = rows.masked_fill(drop, -1)
    # The owner of each probe's partition, the same on every rank.
    owner = (probed // pl)[None, :, :, None].expand(1, b, nprobe, l)
    keys = torch.stack(all_gather(mesh, vdist)).gather(0, owner)[0]
    rows = torch.stack(all_gather(mesh, rows.to(torch.int32))) \
        .gather(0, owner)[0]
    return (keys.reshape(b, -1), rows.reshape(b, -1),
            probed.to(torch.int32))

