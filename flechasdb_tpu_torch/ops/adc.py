"""Coarse partition scores, ADC tables and the masked full scan (the JAX
package's ``ops/adc.py``).

The masked layout keeps flat ``codes [N, D]`` and ``pidx [N]`` and scores
every row with its own partition's table, then masks the rows of
unprobed partitions to ``+inf``: results equal the pruned bucketed scan's.
The JAX package runs it in XLA, outside any Pallas kernel; here it is
PyTorch gathers and full-f32 products. Top-nprobe is a stable ascending
sort and top-k an integer top-k over (key, row) pairs
(:func:`smallest_k`); both keep ``lax.top_k``'s lower-index rule on ties.
Range search (:func:`range_masked_scan`) returns every row's key instead.
With an OPQ ``rotation [M, M]`` the codes live in the rotated space: the
residual (L2) or the query (dot) is rotated before the tables are built,
in full f32 as every product here; coarse scores do not change.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import annotate
from .distance import full_f32, sqdist


@full_f32()
def coarse_scores(q: torch.Tensor, centroids: torch.Tensor,
                  metric: str = "l2") -> torch.Tensor:
    """Partition ranking keys ``[B, P]``, lower is better: squared L2
    distance, or ``−q·cᵀ`` for ``metric="dot"``."""
    if metric == "dot":
        return -torch.matmul(q, centroids.T)
    return sqdist(q, centroids)


def _rotated(v: torch.Tensor,
             rotation: Optional[torch.Tensor]) -> torch.Tensor:
    """``v @ rotation`` in full f32 (``v`` itself without a rotation)."""
    if rotation is None:
        return v
    with full_f32():
        return torch.matmul(v, rotation)


@full_f32()
def _dot_tables(q: torch.Tensor, codebooks: torch.Tensor,
                cent_scores: torch.Tensor,
                rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MIPS ADC tables ``[B, J, D, C]`` with the per-partition scalar
    folded in: ``t[b, j, d, c] = −⟨q'_d, cb[d, c]⟩ + cent_scores[b, j]/D``
    with ``q' = q @ R`` under OPQ (R is orthogonal, so ``⟨q, r⟩ = ⟨qR,
    rR⟩``), so the lookup-sum over d yields ``−⟨q, x̂⟩``."""
    b, _ = q.shape
    d, _, sub = codebooks.shape
    qc = torch.einsum("bds,dcs->bdc",
                      _rotated(q, rotation).reshape(b, d, sub), codebooks)
    return cent_scores[..., None, None] / d - qc[:, None, :, :]


@full_f32()
def adc_tables(q: torch.Tensor, centroids: torch.Tensor,
               codebooks: torch.Tensor,
               rotation: Optional[torch.Tensor] = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse distances and L2 ADC tables for every partition: ``(coarse
    [B, P], tables [B, P, D, C])``, ``tables[b, p, d, c] = ‖(q_b −
    cent_p)_d − cb[d, c]‖²`` clamped at 0, the residual rotated by the
    OPQ ``rotation`` before division when given."""
    b, _ = q.shape
    p = centroids.shape[0]
    d, _, sub = codebooks.shape
    coarse = sqdist(q, centroids)
    resid = _rotated(q[:, None, :] - centroids[None, :, :], rotation) \
        .reshape(b, p, d, sub)
    rr = (resid * resid).sum(dim=-1)                        # [B, P, D]
    cc = (codebooks * codebooks).sum(dim=-1)                # [D, C]
    rc = torch.einsum("bpds,dcs->bpdc", resid, codebooks)
    # (rr + cc) − 2·rc in place: 2·rc is exact, so these are the bits of
    # the out-of-place expression with two [B, P, D, C] buffers, not four.
    tables = (rr[..., None] + cc[None, None]).sub_(rc, alpha=2.0)
    return coarse, tables.clamp_min_(0.0)


@full_f32()
def masked_scan_keys(q: torch.Tensor, centroids: torch.Tensor,
                     codebooks: torch.Tensor, codes: torch.Tensor,
                     pidx: torch.Tensor, metric: str = "l2",
                     rotation: Optional[torch.Tensor] = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every row's ADC ranking key over the flat layout: ``(vdist [B, N],
    coarse [B, P])``. L2 gathers from per-partition tables ``[B, P, D,
    C]``; dot decomposes as ``coarse[pidx] − Σ_d ⟨q_d, cb[d, code]⟩`` and
    builds only a ``[B, D, C]`` table. The sum over d accumulates one
    ``[B, N]`` gather a division, so no ``[B, N, D]`` gather is held.
    ``rotation``: the OPQ rotation the codes were made in."""
    b, _ = q.shape
    d, c, sub = codebooks.shape
    with annotate("fdb.tables"):
        if metric == "dot":
            coarse = coarse_scores(q, centroids, metric)
            qc = torch.einsum("bds,dcs->bdc",
                              _rotated(q, rotation).reshape(b, d, sub),
                              codebooks)
            flat = qc.reshape(b, d * c)
        else:
            coarse, tables = adc_tables(q, centroids, codebooks, rotation)
            flat = tables.reshape(b, -1)

    def column(j: int) -> torch.Tensor:                    # [B, N]
        return flat[:, codes[:, j].long().add_(base).add_(j * c)]

    with annotate("fdb.scan"):
        base = 0 if metric == "dot" else pidx.long() * (d * c)
        vals = column(0)
        for j in range(1, d):
            vals += column(j)
        if metric == "dot":
            return coarse[:, pidx.long()].sub_(vals), coarse
        return vals, coarse


def smallest_k(keys: torch.Tensor, k: int,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``keys [B, N]`` f32,
    ascending, the lower index first among equal keys (a stable sort's
    order): ``(values [B, k], indices [B, k] int64)``, for N < 2³². One
    integer top-k over ``(order-preserving key bits << 32) + index``,
    whose entries are all distinct, so it needs no stable sort (whose CUDA
    scratch is several times its keys below 10⁶ columns): it holds 16
    bytes a row beside the keys."""
    n = keys.shape[1]
    bits = (keys + 0.0).view(torch.int32)        # + 0.0: −0 ties +0
    # Mirroring the negative floats makes signed integers order as floats.
    order = (bits >> 31).bitwise_and_(0x7FFFFFFF).bitwise_xor_(bits)
    del bits
    pairs = order.long().bitwise_left_shift_(32)
    del order
    pairs += torch.arange(n, device=keys.device)
    idx = torch.topk(pairs, k, dim=1, largest=False).values \
        .bitwise_and_(0xFFFFFFFF)
    return keys.gather(1, idx), idx


def _probed_keys(q: torch.Tensor, centroids: torch.Tensor,
                 codebooks: torch.Tensor, codes: torch.Tensor,
                 pidx: torch.Tensor, row_mask: Optional[torch.Tensor],
                 nprobe: int, metric: str,
                 rotation: Optional[torch.Tensor],
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vdist [B, N], probed [B, nprobe])``: every row's key, ``+inf``
    in the partitions not probed and where ``row_mask`` is False."""
    vdist, coarse = masked_scan_keys(q, centroids, codebooks, codes, pidx,
                                     metric, rotation)
    with annotate("fdb.probe"):
        probed = torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]
        keep = torch.zeros_like(coarse, dtype=torch.bool).scatter_(
            1, probed, True)[:, pidx.long()]
        if row_mask is not None:
            keep &= row_mask[None, :]
        return vdist.masked_fill_(~keep, float("inf")), probed


def query_masked_scan(q: torch.Tensor, centroids: torch.Tensor,
                      codebooks: torch.Tensor, codes: torch.Tensor,
                      pidx: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None, *,
                      k: int, nprobe: int, metric: str = "l2",
                      rotation: Optional[torch.Tensor] = None,
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched IVF-PQ k-NN over the flat layout: ``(distances [B, k], rows
    [B, k] int32, probed [B, nprobe] int32)``, ``+inf`` past the reachable
    vectors. ``row_mask [N] bool`` (optional) excludes the rows whose
    entry is False (attribute filters, :mod:`..filters`); ``rotation``
    is the OPQ rotation the codes were made in."""
    n = codes.shape[0]
    vdist, probed = _probed_keys(q, centroids, codebooks, codes, pidx,
                                 row_mask, nprobe, metric, rotation)
    with annotate("fdb.topk"):
        kk = min(k, n)
        dist, rows = smallest_k(vdist, kk)
        if kk < k:
            dist = torch.nn.functional.pad(dist, (0, k - kk),
                                           value=float("inf"))
            rows = torch.nn.functional.pad(rows, (0, k - kk))
        return dist, rows.to(torch.int32), probed.to(torch.int32)


def range_masked_scan(q: torch.Tensor, centroids: torch.Tensor,
                      codebooks: torch.Tensor, codes: torch.Tensor,
                      pidx: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None, *,
                      nprobe: int, metric: str = "l2",
                      rotation: Optional[torch.Tensor] = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Range-search candidates on the flat layout: ``(keys [B, N], probed
    [B, nprobe] int32)``, non-candidates at ``+inf``; column ``i`` is
    corpus row ``i``. The caller thresholds on the host."""
    vdist, probed = _probed_keys(q, centroids, codebooks, codes, pidx,
                                 row_mask, nprobe, metric, rotation)
    return vdist, probed.to(torch.int32)
