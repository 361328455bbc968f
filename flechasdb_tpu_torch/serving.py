"""Device-resident serving index (the JAX package's ``serving.py``).

Two layouts, both returning the same results (global corpus rows):

* **bucketed** (default): partition-major padded buckets scanned by
  kernel K-A; work scales with ``nprobe × L``.
* **masked**: flat ``[N, D]`` codes and a masked full scan
  (:func:`.ops.adc.query_masked_scan`); work scales with ``N``. The layout
  policy (``layout=None``) is the JAX package's ``_choose_layout``: masked
  when partition skew pads the buckets past ``PAD_LIMIT``× the corpus.
  Query batches are chunked so the scan's transients stay under
  ``hbm_budget_bytes`` (:func:`_masked_limit`).

Exact rerank (:meth:`DeviceIndex.query_rerank`) re-scores the top ADC
candidates against the original vectors on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._roadmap import not_ported
from .host import check_metric, choose_layout
from .ops.adc import query_masked_scan
from .ops.bucketed import bucketize, query_bucketed
from .ops.distance import full_f32

#: Budget for the masked scan's per-batch transients (its ADC tables are
#: ``[B, P, D, C]`` f32: ~8 GB at the SIFT shape and B=1000).
HBM_BUDGET_BYTES = 2 << 30

LAYOUTS = ("bucketed", "masked")


def _masked_limit(cent_shape, cb_shape, n: int, budget: int,
                  metric: str = "l2") -> int:
    """Largest query batch whose masked-scan transients fit ``budget``,
    counted as :mod:`.ops.adc` allocates them, one step at a time. Per
    query: the top-k (:func:`.ops.adc.smallest_k`) holds its ``[n]`` f32
    keys, their int32 order bits and the int64 (bits, row) pairs; the L2
    table build holds two ``[P, D, C]`` f32 buffers and two copies of the
    residuals ``[P, M]``, and its gather the tables and two ``[n]`` f32
    rows (dot's gather: three rows, under the top-k's). Shared by the
    batch: two ``[n]`` int64 index rows."""
    p, m = cent_shape
    d, c, _ = cb_shape
    per_query = 16 * n
    if metric != "dot":
        per_query = max(per_query, 8 * (p * d * c + p * m),
                        4 * p * d * c + 8 * n)
    return max(1, (budget - 16 * n) // per_query)


@full_f32()
def _rerank_exact(q: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                  x: torch.Tensor, *, k: int, metric: str = "l2",
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of ADC candidates: ``q [B, M]``, candidate corpus
    ``rows [B, R]``, ``valid [B, R]`` (False where the ADC pass ran out of
    reachable vectors), originals ``x [N, M]`` → ``(dists [B, k], rows
    [B, k])``. ``metric="dot"`` scores ``−⟨q, x⟩``; cosine callers pass
    unit vectors and the L2 key. A stable ascending sort keeps the lower
    candidate on ties, as ``lax.top_k`` does."""
    cand = x[rows.clamp_min(0).long()]                      # [B, R, M]
    if metric == "dot":
        exact = -torch.bmm(cand, q[:, :, None])[..., 0]
    else:
        diff = cand - q[:, None, :]
        exact = (diff * diff).sum(dim=-1)
    exact = exact.masked_fill(~valid, float("inf"))
    best = torch.sort(exact, dim=1, stable=True)
    return best.values[:, :k], rows.gather(1, best.indices[:, :k])


def _host(*ts: torch.Tensor) -> tuple[np.ndarray, ...]:
    return tuple(t.cpu().numpy() for t in ts)


class DeviceIndex:
    """IVF-PQ index held on ``device`` (``"cuda"`` by default), ready for
    batched queries. ``layout`` is ``"bucketed"``, ``"masked"`` or ``None``
    (the JAX package's policy)."""

    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 codes: np.ndarray, pidx: np.ndarray,
                 layout: Optional[str] = None,
                 rotation: Optional[np.ndarray] = None,
                 hbm_budget_bytes: int = HBM_BUDGET_BYTES,
                 metric: str = "l2",
                 device: str | torch.device = "cuda") -> None:
        if rotation is not None:
            raise not_ported("An OPQ rotation", 13)
        self.hbm_budget_bytes = hbm_budget_bytes
        # Cosine is L2 over unit vectors: the database layer normalizes.
        self.metric = "dot" if check_metric(metric) == "dot" else "l2"
        self.device = torch.device(device)
        p = centroids.shape[0]
        if layout is None:
            layout = choose_layout(p, pidx, max(len(codes), 1))
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout: {layout!r}")
        self.layout = layout
        self.centroids = torch.tensor(
            np.asarray(centroids, np.float32), device=self.device)
        self.codebooks = torch.tensor(
            np.asarray(codebooks, np.float32), device=self.device)
        self.buckets = self.codes = self.pidx = None
        if layout == "bucketed":
            self.buckets = bucketize(np.asarray(codes, np.int32),
                                     np.asarray(pidx, np.int32), p,
                                     device=self.device)
        else:
            self.codes = torch.tensor(np.asarray(codes, np.int32),
                                      device=self.device)
            self.pidx = torch.tensor(np.asarray(pidx, np.int32),
                                     device=self.device)

    def _masked_batch_limit(self) -> int:
        return _masked_limit(tuple(self.centroids.shape),
                             tuple(self.codebooks.shape),
                             self.codes.shape[0], self.hbm_budget_bytes,
                             self.metric)

    def _query(self, qd: torch.Tensor, k: int, nprobe: int, row_mask,
               approx: bool | float,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device ``(dists, rows, probed)``; masked batches in chunks."""
        if self.layout == "bucketed":
            return query_bucketed(qd, self.centroids, self.codebooks,
                                  self.buckets, row_mask, k=k, nprobe=nprobe,
                                  metric=self.metric, approx=approx)
        limit = self._masked_batch_limit()
        parts = [query_masked_scan(qd[i:i + limit], self.centroids,
                                   self.codebooks, self.codes, self.pidx,
                                   row_mask, k=k, nprobe=nprobe,
                                   metric=self.metric)
                 for i in range(0, len(qd), limit)]
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def query(self, q: np.ndarray, k: int, nprobe: int, row_mask=None,
              approx: bool | float = False,
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched k-NN: ``q [B, M]`` → host ``(dists, rows, probed)``.
        ``approx`` is answered exactly; ``row_mask`` is not ported."""
        qd = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        return _host(*self._query(qd, k, nprobe, row_mask, approx))

    def query_rerank(self, q: np.ndarray, originals: torch.Tensor, k: int,
                     nprobe: int, rerank: int, row_mask=None,
                     approx: bool | float = False,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """ADC query for the top ``rerank`` candidates, then their EXACT
        re-scoring against ``originals [N, M]`` (on this index's device),
        both on the device: host ``(dists [B, k], rows [B, k])``."""
        qd = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        adc, rows, _ = self._query(qd, rerank, nprobe, row_mask, approx)
        return _host(*_rerank_exact(qd, rows, torch.isfinite(adc), originals,
                                    k=k, metric=self.metric))
