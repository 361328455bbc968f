"""Pruned IVF-PQ query over partition-bucketed codes (the JAX package's
``ops/bucketed.py``).

Codes bucketize by partition into a padded ``[P, D, L]`` array (``L``
minor, so the scan reads codes coalesced along it) and a query touches
only its ``nprobe`` buckets:

1. coarse scores and a stable ascending sort pick ``probed [B, nprobe]``,
2. ADC tables for the probed partitions only, ``[B, nprobe, D, C]`` (L2
   on the card: one hand-written kernel, :func:`l2_tables_kernel`),
3. the bucket scan (kernel K-A on the card, :mod:`.scan`), then the
   attribute filter's row mask where one is given,
4. the k best of ``[B, nprobe·L]`` in a stable sort's order
   (:func:`.topk.bucketed_topk`: on the card a selection over the live
   slots), or, for range search (:func:`range_bucketed`), every candidate
   to the host.

The same steps serve a mesh (:mod:`..parallel.bucketed`): they run over
a block of buckets, all ``P`` partitions on one device or a rank's block
of them. Each step is a stage that a runner runs: :func:`eager` runs it
op by op inside its ``fdb.`` span; the graph route of
:class:`..serving.DeviceIndex` captures the same stages as CUDA graphs
and replays each inside the same span.

``torch.topk`` promises no order among equal values, while the JAX
package's ``lax.top_k`` breaks ties to the lower index; a stable sort
gives the same order, which duplicated vectors make visible.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from ..host import bucket_len
from ..utils.profiling import annotate, count
from .adc import _dot_tables, _rotated, coarse_scores
from .distance import full_f32
from .scan import adc_lookup_indexed
from .topk import bucketed_topk


class Buckets(NamedTuple):
    """``codes [P, D, L]`` int32 (0 in pad slots), or packed ``[P,
    ceil(D/4), L]`` with four byte codes a word (division ``d`` in byte
    ``d % 4``); ``rows [P, L]`` int32 corpus row a slot, ``-1`` in pad
    slots; ``lengths [P]`` int32 fill counts."""
    codes: torch.Tensor
    rows: torch.Tensor
    lengths: torch.Tensor


def packs(codes: np.ndarray) -> bool:
    """Whether :func:`bucketize` packs ``codes [N, D]``: four byte codes a
    word, when D > 1 and every code is < 256."""
    return codes.shape[1] > 1 and int(codes.max(initial=0)) < 256


def bucketize(codes: np.ndarray, pidx: np.ndarray, p: int,
              device: str | torch.device = "cpu") -> Buckets:
    """Host-side bucketization of ``codes [N, D]`` by partition, moved to
    ``device``, in the JAX package's ``pack="auto"`` layout: ``L`` is
    :func:`~flechasdb_tpu_torch.host.bucket_len`, and four byte codes pack
    into a word where :func:`packs` says so."""
    codes = np.asarray(codes)
    pidx = np.asarray(pidx)
    n, d = codes.shape
    pack = packs(codes)
    counts = np.bincount(pidx, minlength=p)
    l = bucket_len(counts)
    bcodes = np.zeros((p, d, l), np.int32)
    brows = np.full((p, l), -1, np.int32)
    order = np.argsort(pidx, kind="stable")
    starts = np.zeros(p + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    sorted_p = pidx[order]
    slot = np.arange(n, dtype=np.int64) - starts[sorted_p]
    brows[sorted_p, slot] = order
    bcodes[sorted_p, :, slot] = codes[order]
    if pack:
        packed = np.zeros((p, -(-d // 4), l), np.int32)
        for di in range(d):
            w, b = divmod(di, 4)
            packed[:, w] |= bcodes[:, di] << (8 * b)
        bcodes = packed
    return Buckets(torch.as_tensor(bcodes, device=device),
                   torch.as_tensor(brows, device=device),
                   torch.as_tensor(counts.astype(np.int32), device=device))


@full_f32()
def probed_tables(q: torch.Tensor, centroids: torch.Tensor,
                  codebooks: torch.Tensor, probed: torch.Tensor,
                  metric: str = "l2",
                  coarse: Optional[torch.Tensor] = None,
                  rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ADC tables ``[B, nprobe, D, C]`` for the probed partitions only.

    L2: ``‖(q − centroid_p)_d − cb[d, c]‖²``, the residual rotated by the
    OPQ ``rotation`` first when given (the codes live in the rotated
    space): on a CUDA tensor the kernel of ``csrc/probed_tables.cu``
    (:func:`l2_tables_kernel`), else :func:`l2_tables_plain`. Dot: the
    :func:`.adc._dot_tables` decomposition, its per-probe scalars gathered
    from ``coarse [B, P]`` when given. The counters ``tables.kernel`` and
    ``tables.plain`` count the cells (B·nprobe) each route took."""
    b = q.shape[0]
    nprobe = probed.shape[1]
    if metric == "dot":
        count("tables.plain", b * nprobe)
        if coarse is not None:
            cent_scores = coarse.gather(1, probed)
        else:
            pc = centroids[probed]                          # [B, nprobe, M]
            cent_scores = -torch.einsum("bm,bjm->bj", q, pc)
        return _dot_tables(q, codebooks, cent_scores, rotation)
    if q.device.type == "cuda":
        count("tables.kernel", b * nprobe)
        return l2_tables_kernel(q, centroids, codebooks, probed, rotation)
    count("tables.plain", b * nprobe)
    return l2_tables_plain(q, centroids, codebooks, probed, rotation)


@full_f32()
def l2_tables_plain(q: torch.Tensor, centroids: torch.Tensor,
                    codebooks: torch.Tensor, probed: torch.Tensor,
                    rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The L2 tables by the expansion ``rr + cc − 2·rc``, clamped at 0 (the
    plain version: the CPU's route, the kernel's reference)."""
    b = q.shape[0]
    nprobe = probed.shape[1]
    d, c, sub = codebooks.shape
    resid = _rotated(q[:, None, :] - centroids[probed], rotation) \
        .reshape(b, nprobe, d, sub)
    rr = (resid * resid).sum(dim=-1)                        # [B, nprobe, D]
    cc = (codebooks * codebooks).sum(dim=-1)                # [D, C]
    rc = torch.einsum("bjds,dcs->bjdc", resid, codebooks)
    return torch.clamp_min(rr[..., None] + cc[None, None] - 2.0 * rc, 0.0)


def _check_tables(q, centroids, codebooks, probed, rotation) -> None:
    """What the kernel takes: f32 ``q [B, M]``, ``centroids [P, M]`` and
    ``codebooks [D, C, M/D]`` and int64 ``probed [B, nprobe]`` (rows may lie
    apart, as a slice of the probe's sort gives them), one device, the
    floats contiguous; ``rotation [M, M]`` f32."""
    if q.ndim != 2 or centroids.ndim != 2 or codebooks.ndim != 3 \
            or probed.ndim != 2:
        raise ValueError(
            f"want q [B, M], centroids [P, M], codebooks [D, C, sub] and "
            f"probed [B, nprobe], got {tuple(q.shape)}, "
            f"{tuple(centroids.shape)}, {tuple(codebooks.shape)}, "
            f"{tuple(probed.shape)}")
    b, m = q.shape
    d, c, sub = codebooks.shape
    if centroids.shape[1] != m or d * sub != m or probed.shape[0] != b:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, centroids "
            f"{tuple(centroids.shape)}, codebooks {tuple(codebooks.shape)}, "
            f"probed {tuple(probed.shape)}")
    if b * probed.shape[1] >= 2 ** 31 or centroids.shape[0] >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2³¹ cells and "
                         "partitions")
    floats = {"q": q, "centroids": centroids, "codebooks": codebooks}
    if rotation is not None:
        if rotation.shape != (m, m):
            raise ValueError(f"rotation shape {tuple(rotation.shape)} != "
                             f"({m}, {m})")
        floats["rotation"] = rotation
    for name, t in {**floats, "probed": probed}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if probed.dtype != torch.int64:
        raise TypeError(f"probed must be torch.int64, got {probed.dtype}")
    if probed.numel() > probed.shape[0] and probed.stride(1) != 1:
        raise ValueError("probed's rows must be contiguous")


def l2_tables_kernel(q: torch.Tensor, centroids: torch.Tensor,
                     codebooks: torch.Tensor, probed: torch.Tensor,
                     rotation: Optional[torch.Tensor] = None,
                     ) -> torch.Tensor:
    """The L2 tables on the card: one launch of ``csrc/probed_tables.cu``,
    which forms each residual from ``q`` and the gathered centroid and
    writes ``Σ_s (r_s − cb[d, c, s])²`` once, in f32 (no clamp: the
    difference form is ≥ 0). With a ``rotation`` the rotated residuals are
    formed here and handed to the kernel in place of ``q``. Raises on what
    the kernel does not take (:func:`_check_tables`)."""
    _check_tables(q, centroids, codebooks, probed, rotation)
    b = q.shape[0]
    nprobe = probed.shape[1]
    d, c, sub = codebooks.shape
    dev = q.device
    out = torch.empty((b, nprobe, d, c), dtype=torch.float32, device=dev)
    g = b * nprobe
    if g == 0:
        return out
    src, cent = q, centroids
    if rotation is not None:
        src = _rotated(q[:, None, :] - centroids[probed], rotation) \
            .reshape(g, -1).contiguous()
        cent = None
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.fdb_probed_tables(
            src.data_ptr(), None if cent is None else cent.data_ptr(),
            probed.data_ptr(), codebooks.data_ptr(), out.data_ptr(), g,
            nprobe, probed.stride(0), centroids.shape[0], d, c, sub,
            _kernels.stream_of(q))
    _kernels.check(rc, "probed_tables")
    _kernels.launched("probed_tables")
    return out


def eager(span: str, fn, *args):
    """Runs one stage of the pipeline, ``fn(*args)``, op by op inside the
    span ``span``. The stage runner of every call but those of serving's
    graph route (:class:`..serving.DeviceIndex`), whose runner captures
    each stage into a CUDA graph and replays it inside the same span."""
    with annotate(span):
        return fn(*args)


def _probe(q: torch.Tensor, centroids: torch.Tensor, lengths: torch.Tensor,
           first: int, nprobe: int, l: int, metric: str,
           ) -> tuple[torch.Tensor, ...]:
    """Step 1 over a block of ``Pl = len(lengths)`` buckets from partition
    ``first``: ``(coarse [B, P], probed [B, nprobe], slot [B, nprobe], lens
    [B, nprobe])``; counts the slots of the probes the block holds."""
    b, pl = q.shape[0], lengths.shape[0]
    coarse = coarse_scores(q, centroids, metric)            # [B, P]
    probed = torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]
    if first == 0 and pl == centroids.shape[0]:             # every partition
        slot, held = probed, b * nprobe * l
        lens = lengths[probed]                              # [B, nprobe]
    else:
        local = probed - first
        owned = (local >= 0) & (local < pl)
        slot, held = torch.where(owned, local, 0), owned * l
        lens = torch.where(owned, lengths[slot], 0)
    count("bucketed.slots", held)
    count("bucketed.real_slots", lens)
    return coarse, probed, slot, lens


def _tables(q: torch.Tensor, centroids: torch.Tensor,
            codebooks: torch.Tensor, probed: torch.Tensor, metric: str,
            coarse: torch.Tensor, rotation: Optional[torch.Tensor],
            ) -> torch.Tensor:
    """Step 2: :func:`probed_tables`, its cells counted."""
    count("tables.cells", probed.numel())
    return probed_tables(q, centroids, codebooks, probed, metric, coarse,
                         rotation)


def _scan(bcodes: torch.Tensor, tables: torch.Tensor, slot: torch.Tensor,
          lens: torch.Tensor, d: int,
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 3, K-A over the probed buckets: ``(vdist [B, nprobe, L], bidx
    [B·nprobe] int32, lens [B·nprobe] int32)``."""
    b, nprobe = slot.shape
    bidx = slot.reshape(-1).to(torch.int32).contiguous()
    lens = lens.reshape(-1).contiguous()
    vdist = adc_lookup_indexed(
        bcodes, tables.reshape(b * nprobe, -1).contiguous(), bidx, lens,
        d=d)                                                # [B·nprobe, L]
    return vdist.reshape(b, nprobe, bcodes.shape[2]), bidx, lens


def _probe_scan(q: torch.Tensor, centroids: torch.Tensor,
                codebooks: torch.Tensor, buckets: Buckets, first: int,
                nprobe: int, metric: str, rotation: Optional[torch.Tensor],
                run=eager,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Steps 1–3 over ``buckets``, a block that holds partitions ``[first,
    first + Pl)`` (all ``P`` of them on one device; a rank's block of a
    mesh, :mod:`..parallel.bucketed`), each step a stage that ``run``
    runs (:func:`eager`): ``(vdist [B, nprobe, L], probed [B, nprobe],
    slot [B, nprobe], bidx [B·nprobe] int32, lens [B·nprobe] int32)``.
    ``slot`` is each probe's bucket in the block, ``bidx`` and ``lens``
    the buckets and lengths flat as K-A takes them; a probe the block
    does not hold takes slot 0 and length 0, and K-A writes ``+inf`` past
    each length. The counters count the slots of the probes the block
    holds."""
    coarse, probed, slot, lens = run(
        "fdb.probe", _probe, q, centroids, buckets.lengths, first, nprobe,
        buckets.codes.shape[2], metric)
    tables = run("fdb.tables", _tables, q, centroids, codebooks, probed,
                 metric, coarse, rotation)
    vdist, bidx, lens = run("fdb.scan", _scan, buckets.codes, tables, slot,
                            lens, codebooks.shape[0])
    return vdist, probed, slot, bidx, lens


def topk_rows(vdist: torch.Tensor, lens: torch.Tensor, bidx: torch.Tensor,
              brows: torch.Tensor, *, k: int,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 4 over ``vdist [B, nprobe, L]`` with the cells' ``lens`` and
    buckets ``bidx`` (``[B·nprobe]`` int32) and the buckets' ``brows [P,
    L]``: ``(distances [B, k], rows [B, k] int32)``, ``+inf`` and row 0
    past the ``nprobe·L`` slots."""
    b, nprobe, l = vdist.shape
    kk = min(k, nprobe * l)
    dist, _, rows = bucketed_topk(vdist.reshape(b * nprobe, l), lens, bidx,
                                  brows, nprobe=nprobe, kk=kk)
    if kk < k:
        dist = torch.nn.functional.pad(dist, (0, k - kk), value=float("inf"))
        rows = torch.nn.functional.pad(rows, (0, k - kk))
    return dist, rows


def _kept(rows: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """``row_mask`` at each slot's corpus row (pad slots read row 0: their
    keys are ``+inf`` whatever it says)."""
    return row_mask[rows.clamp_min(0).long()]


def query_bucketed(q: torch.Tensor, centroids: torch.Tensor,
                   codebooks: torch.Tensor, buckets: Buckets,
                   row_mask: Optional[torch.Tensor] = None, *,
                   k: int, nprobe: int, metric: str = "l2",
                   approx: bool | float = False,
                   rotation: Optional[torch.Tensor] = None,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched pruned IVF-PQ k-NN: ``(distances [B, k], rows [B, k] int32,
    probed [B, nprobe] int32)``, ``+inf`` past the reachable vectors.

    ``row_mask [N] bool`` (optional, on the buckets' device) excludes the
    corpus rows whose entry is False (attribute filters, :mod:`..filters`).
    ``approx`` is accepted and answered exactly, as the JAX package does
    off the TPU. ``rotation``: the OPQ rotation the codes were made in
    (K-A scans the rotated tables unchanged)."""
    return _query_block(q, centroids, codebooks, buckets, row_mask, 0, k=k,
                        nprobe=nprobe, metric=metric, rotation=rotation)


def _masked(vdist: torch.Tensor, brows: torch.Tensor, slot: torch.Tensor,
            row_mask: torch.Tensor) -> torch.Tensor:
    """``+inf`` at the slots whose rows ``row_mask`` drops (one gather and
    select)."""
    return vdist.masked_fill(~_kept(brows[slot], row_mask), float("inf"))


def _topk(vdist: torch.Tensor, lens: torch.Tensor, bidx: torch.Tensor,
          brows: torch.Tensor, probed: torch.Tensor, k: int,
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 4: :func:`topk_rows`, and the probes as int32."""
    dist, rows = topk_rows(vdist, lens, bidx, brows, k=k)
    return dist, rows, probed.to(torch.int32)


def _query_block(q: torch.Tensor, centroids: torch.Tensor,
                 codebooks: torch.Tensor, buckets: Buckets,
                 row_mask: Optional[torch.Tensor], first: int, *, k: int,
                 nprobe: int, metric: str, rotation: Optional[torch.Tensor],
                 run=eager,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`query_bucketed` over a block of buckets that starts at
    partition ``first`` (:func:`_probe_scan`), each stage run by ``run``:
    the block's own ``k`` best."""
    vdist, probed, slot, bidx, lens = _probe_scan(
        q, centroids, codebooks, buckets, first, nprobe, metric, rotation,
        run)
    if row_mask is not None:
        vdist = run("fdb.scan", _masked, vdist, buckets.rows, slot, row_mask)
    return run("fdb.topk", _topk, vdist, lens, bidx, buckets.rows, probed, k)


def range_bucketed(q: torch.Tensor, centroids: torch.Tensor,
                   codebooks: torch.Tensor, buckets: Buckets,
                   row_mask: Optional[torch.Tensor] = None, *,
                   nprobe: int, metric: str = "l2",
                   rotation: Optional[torch.Tensor] = None,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range-search candidates: every probed vector's ADC key, ``(keys [B,
    nprobe·L], rows [B, nprobe·L] int32, probed [B, nprobe] int32)`` in
    probe order, then slot; pad slots and filtered rows are ``+inf`` and
    row ``-1``. The same probe selection and K-A scan as
    :func:`query_bucketed`, with no top-k: the caller thresholds on the
    host. The JAX package scans without lengths and masks ``slot <
    length`` afterwards; here K-A takes the lengths and writes the pad
    slots' ``+inf`` itself (the keys are the same), and a pad slot's row
    is already ``-1`` in :class:`Buckets`."""
    return _range_block(q, centroids, codebooks, buckets, row_mask, 0,
                        nprobe=nprobe, metric=metric, rotation=rotation)


def _range_block(q: torch.Tensor, centroids: torch.Tensor,
                 codebooks: torch.Tensor, buckets: Buckets,
                 row_mask: Optional[torch.Tensor], first: int, *,
                 nprobe: int, metric: str, rotation: Optional[torch.Tensor],
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`range_bucketed` over a block of buckets that starts at
    partition ``first`` (:func:`_probe_scan`): a probe the block does not
    hold gives ``+inf`` keys, and rows the block's bucket 0 holds."""
    b = q.shape[0]
    vdist, probed, slot, _, _ = _probe_scan(
        q, centroids, codebooks, buckets, first, nprobe, metric, rotation)
    rows = buckets.rows[slot]                               # [B, nprobe, L]
    if row_mask is not None:
        drop = ~_kept(rows, row_mask)
        vdist = vdist.masked_fill(drop, float("inf"))
        rows = rows.masked_fill(drop, -1)
    return (vdist.reshape(b, -1), rows.reshape(b, -1).to(torch.int32),
            probed.to(torch.int32))
