"""The comparison that decides ``correct``: each number the program's
answers read against the plain reference, computed in float64
(:data:`.arith.F64`). Every number is scale-free and reads 0 for a perfect
answer; a cell's limits are in ``limits/<cell>.json``.

Search (:func:`serve_numbers`), over a sample of the answered queries:

* ``miss_pct``: the share, in %, of answer slots whose row is not among
  the best ``k``: its reference key lies above the reference's ``k``-th
  best by more than :data:`TIE` of it, or it is no corpus row, repeats a
  row of the same answer, or is missing where the reference has a row.
* ``dist_err``: the widest gap between a reported distance and the
  reference's key of the same row, over the reference's ``k``-th best of
  that query.

Build (:func:`build_numbers`):

* ``assign_gap``: over a sample of rows, the widest amount by which a row's
  partition lies farther than its nearest centroid, over the sample's mean
  distance to the nearest centroid.
* ``code_gap``: the same for each code against its division's nearest
  codeword, the residual taken from the row's own partition.
* ``lloyd_gain``: the share of the distortion one more Lloyd update of the
  built centroids (or codebooks) would remove, over every row: ``Σ_p n_p
  ‖c_p − m_p‖² / Σ_rows ‖x − m_p(x)‖²``, ``m_p`` the mean of the rows
  assigned to ``p``; the larger of the coarse and PQ readings.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .arith import F64
from .ivfpq import Partitions, keys_of, search, sqdist

#: Relative slack within which a row ties the reference's ``k``-th best.
TIE = 1e-5


def serve_numbers(x: torch.Tensor, q: torch.Tensor, centroids: torch.Tensor,
                  codebooks: torch.Tensor, codes: torch.Tensor,
                  pidx: torch.Tensor, rows: torch.Tensor,
                  dists: torch.Tensor, *, k: int, nprobe: int,
                  rerank: Optional[int] = None) -> dict:
    """``rows [S, k]`` and ``dists [S, k]`` the program's answers to ``q
    [S, M]`` (a slot whose distance is not finite holds no row); the index arrays are the
    program's build, read to work out the IVF-PQ answer over them."""
    rows = torch.where(torch.isfinite(dists), rows.long(), -1)
    parts = Partitions(pidx, centroids.shape[0])
    ref_keys, ref_rows = search(x, q, centroids, codebooks, codes, pidx,
                                k=k, nprobe=nprobe, rerank=rerank,
                                arith=F64, parts=parts)
    got = keys_of(x, q, centroids, codebooks, codes, pidx, rows,
                  exact=bool(rerank))
    kth = ref_keys[:, k - 1:k]
    scale = torch.where(torch.isfinite(kth) & (kth > 0), kth,
                        torch.ones_like(kth))
    valid = rows >= 0
    srt = torch.sort(rows, dim=1).values
    dup = torch.zeros_like(valid)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    bad = (valid & torch.isnan(got)) | dup
    worse = valid & (got > kth + TIE * scale)
    absent = ~valid & (ref_rows >= 0)
    miss = (bad | worse | absent).sum().item()
    err = ((dists.double() - got).abs() / scale)[valid & ~torch.isnan(got)]
    dist_err = float(err.max()) if err.numel() else 0.0
    if not math.isfinite(dist_err):
        dist_err = math.inf
    return {"miss_pct": 100.0 * miss / rows.numel(), "dist_err": dist_err}


def _gap(d: torch.Tensor, chosen: torch.Tensor) -> tuple[float, float]:
    """``(widest gap of the chosen entry over the row's minimum, sum of the
    minima)`` of ``d [R, K]``."""
    dmin = d.min(-1).values
    got = d.gather(-1, chosen[..., None])[..., 0]
    return float((got - dmin).max()), float(dmin.sum())


def _lloyd_gain(vals: torch.Tensor, labels: torch.Tensor,
                cents: torch.Tensor, chunk: int) -> float:
    """``Σ_p n_p ‖c_p − m_p‖² / Σ ‖v − m_label(v)‖²`` for ``vals [N, m]``
    with ``labels [N]`` into ``cents [K, m]``, over row chunks."""
    k, m = cents.shape
    sums = torch.zeros((k, m), dtype=torch.float64, device=cents.device)
    counts = torch.zeros(k, dtype=torch.float64, device=cents.device)
    sq = 0.0
    for s in range(0, vals.shape[0], chunk):
        v = vals[s:s + chunk].double()
        lab = labels[s:s + chunk].long()
        sums.index_add_(0, lab, v)
        counts += torch.bincount(lab, minlength=k).double()
        sq += float((v * v).sum())
    live = counts > 0
    means = sums[live] / counts[live, None]
    within = sq - float((counts[live] * (means * means).sum(-1)).sum())
    moved = float((counts[live]
                   * ((cents.double()[live] - means) ** 2).sum(-1)).sum())
    return moved / within if within > 0 else math.inf


def build_numbers(x: torch.Tensor, centroids: torch.Tensor,
                  idx: torch.Tensor, codebooks: torch.Tensor,
                  codes: torch.Tensor, sample: torch.Tensor, *,
                  p: int, d: int, c: int, chunk: int = 1 << 16) -> dict:
    """The build numbers of ``(centroids, idx, codebooks, codes)``, the
    program's arrays for ``x [N, M]``, the gaps over the rows ``sample``."""
    n, m = x.shape
    sub = m // d
    shapes_ok = (tuple(centroids.shape) == (p, m)
                 and tuple(idx.shape) == (n,)
                 and tuple(codebooks.shape) == (d, c, sub)
                 and tuple(codes.shape) == (n, d))
    if not shapes_ok:
        return {"assign_gap": math.inf, "code_gap": math.inf,
                "lloyd_gain": math.inf}
    idx, codes = idx.long(), codes.long()
    if (int(idx.min()) < 0 or int(idx.max()) >= p or int(codes.min()) < 0
            or int(codes.max()) >= c or not torch.isfinite(centroids).all()
            or not torch.isfinite(codebooks).all()):
        return {"assign_gap": math.inf, "code_gap": math.inf,
                "lloyd_gain": math.inf}
    cents = centroids.double()
    books = codebooks.double()
    a_gap = c_gap = 0.0
    a_sum = c_sum = 0.0
    for s in range(0, len(sample), chunk):
        rows = sample[s:s + chunk]
        xs = x[rows].double()
        g, t = _gap(sqdist(xs, cents, F64), idx[rows])
        a_gap, a_sum = max(a_gap, g), a_sum + t
        r = (xs - cents[idx[rows]]).reshape(-1, d, sub).transpose(0, 1)
        g, t = _gap(sqdist(r, books, F64), codes[rows].T)
        c_gap, c_sum = max(c_gap, g), c_sum + t
    a_mean = a_sum / len(sample)
    c_mean = c_sum / (len(sample) * d)
    coarse = _lloyd_gain(x, idx, centroids, chunk)
    flat = (codes + torch.arange(d, device=x.device) * c).reshape(-1)
    pq = _lloyd_gain(_Residuals(x, centroids, idx, d), flat,
                     books.reshape(d * c, sub), chunk * d)
    return {"assign_gap": a_gap / a_mean if a_mean > 0 else math.inf,
            "code_gap": c_gap / c_mean if c_mean > 0 else math.inf,
            "lloyd_gain": max(coarse, pq)}


class _Residuals:
    """The residual subvectors of every row, ``[N·D, M/D]`` row-major,
    made a slice at a time (never held whole)."""

    def __init__(self, x: torch.Tensor, cents: torch.Tensor,
                 idx: torch.Tensor, d: int) -> None:
        self.x, self.cents, self.idx, self.d = x, cents, idx, d
        self.shape = (x.shape[0] * d, x.shape[1] // d)

    def __getitem__(self, sl: slice) -> torch.Tensor:
        a, b = sl.start // self.d, sl.stop // self.d
        xs = self.x[a:b].double()
        return (xs - self.cents.double()[self.idx[a:b]]).reshape(
            -1, self.shape[1])
