"""Device-resident serving index (the JAX package's ``serving.py``).

Two layouts, both returning the same results (global corpus rows):

* **bucketed** (default): partition-major padded buckets scanned by
  kernel K-A; work scales with ``nprobe × L``.
* **masked**: flat ``[N, D]`` codes and a masked full scan
  (:func:`.ops.adc.query_masked_scan`); work scales with ``N``. Query
  batches are chunked so the scan's transients stay under
  ``hbm_budget_bytes`` (:func:`_masked_limit`).

The layout policy (``layout=None``) depends on the index's device. On a
CUDA device it is the card's own rule, :func:`card_layout`: buckets while
they cost no more than the masked scan at any ``nprobe`` (a pad ratio up
to :data:`CARD_PAD_LIMIT`, measured on the card) and fit
:data:`CARD_BUCKET_SHARE` of the card's memory. Elsewhere it is the JAX
package's ``_choose_layout`` (:func:`.host.choose_layout`): masked when
partition skew pads the buckets past ``PAD_LIMIT``× the corpus.

Exact rerank (:meth:`DeviceIndex.query_rerank`) re-scores the top ADC
candidates against the original vectors on the device. Every query takes
an optional ``row_mask [N] bool`` (attribute filters). Range search
(:meth:`DeviceIndex.query_range`) scans as a query does and thresholds
every candidate on the host. An OPQ ``rotation`` is uploaded once and
rotates every query's tables (:mod:`.ops.adc`, :mod:`.ops.bucketed`).
:class:`ShardedIndex` serves both layouts over a mesh of ranks
(:mod:`.parallel`).

The graph route (:class:`_Graphs`): on a CUDA device, a
:class:`DeviceIndex` with the bucketed layout answers a query or a
reranked query without a ``row_mask`` by replaying CUDA graphs, one a
stage of the pipeline (``fdb.probe``, ``fdb.tables``, ``fdb.scan``,
``fdb.topk``, ``fdb.rerank``), once the call's shape has been seen
before; every other call runs the same stages op by op.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled

from . import _kernels
from .host import bucket_len, check_metric, choose_layout
from .ops.adc import query_masked_scan, range_masked_scan
from .ops.bucketed import (Buckets, _query_block, bucketize, eager, packs,
                           range_bucketed)
from .ops.distance import full_f32
from .parallel.bucketed import (query_bucketed_sharded,
                                range_bucketed_sharded, shard_buckets)
from .parallel.mesh import shard_corpus, shard_mask
from .parallel.query import query_sharded, range_sharded
from .utils.profiling import annotate, annotated, count, recording

#: The most call shapes a :class:`DeviceIndex` keeps CUDA graphs for, and
#: the most it remembers as seen once; least recently used out.
GRAPH_KEYS = 4

#: Budget for the masked scan's per-batch transients (its ADC tables are
#: ``[B, P, D, C]`` f32: ~8 GB at the SIFT shape and B=1000).
HBM_BUDGET_BYTES = 2 << 30

LAYOUTS = ("bucketed", "masked")

#: The card's break-even pad ratio of the bucketed layout: the masked
#: scan's device time a query-row over the bucketed pipeline's device time
#: a query-slot, measured on an H100 at the SIFT1M shape (1M × 128,
#: P=1024, D=8, C=256) with every partition probed, the buckets' worst
#: case (``profile_layout.py``): 13.1 at a batch of 1 query, 25–32 at
#: 16–256, rounded down. Buckets padded to at most this many slots a row
#: cost no more than the masked scan at any ``nprobe``.
CARD_PAD_LIMIT = 13.0

#: The share of a card's memory the buckets may take; the rest holds the
#: originals a rerank reads, the graph route's pools and the query's
#: transients.
CARD_BUCKET_SHARE = 0.25


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


def card_layout(counts, n: int, d: int, memory: int,
                packed: bool = True) -> str:
    """The layout policy on a CUDA device, from the partitions' sizes
    ``counts [P]``, the corpus's ``n`` rows of ``d`` codes and the card's
    ``memory`` in bytes: ``"bucketed"`` while the ``[P, L]`` buckets
    (:func:`.host.bucket_len`) hold at most :data:`CARD_PAD_LIMIT` slots
    a row and their bytes fit :data:`CARD_BUCKET_SHARE` of ``memory``,
    else ``"masked"``. The bytes: the codes and rows on the card
    (``ceil(d/4)`` words a slot where the codes are ``packed``, else
    ``d``) and the host's unpacked ``[P, d, L]`` codes that
    :func:`.ops.bucketed.bucketize` fills first."""
    p = len(counts)
    slots = p * bucket_len(counts)
    words = -(-d // 4) if packed else d
    nbytes = 4 * slots * (words + 1 + d)
    fits = nbytes <= CARD_BUCKET_SHARE * memory
    return "bucketed" if fits and slots <= CARD_PAD_LIMIT * max(n, 128) \
        else "masked"


def _range_limit(nprobe: int, l: int, cb_shape, budget: int) -> int:
    """Largest query batch whose bucketed range-scan transients fit
    ``budget``: per query the probed tables ``[nprobe, D, C]`` f32 and the
    keys and rows ``[nprobe, L]`` f32 and int32, twice (the JAX package's
    rule)."""
    d, c, _ = cb_shape
    per_query = 4 * nprobe * (d * c + 4 * l)
    return max(1, budget // per_query)


def _range_host_tail(keys: np.ndarray, rows: np.ndarray,
                     radius: float) -> list:
    """Thresholds range-scan candidates (``+inf``: none) into one ``(rows
    int64[], keys f32[])`` pair a query, keys ascending; a stable sort
    keeps the candidates' order (probe, then slot; or corpus row) on
    ties."""
    out = []
    for b in range(len(keys)):
        hit = keys[b] <= radius
        kb, rb = keys[b][hit], rows[b][hit]
        order = np.argsort(kb, kind="stable")
        out.append((rb[order].astype(np.int64), kb[order]))
    return out


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


def _rerank(q: torch.Tensor, adc: torch.Tensor, rows: torch.Tensor,
            x: torch.Tensor, k: int, metric: str,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rerank stage: the ADC pass's candidates that hold a row (counted
    as ``rerank.rows``), exactly re-scored by :func:`_rerank_exact`."""
    valid = torch.isfinite(adc)
    count("rerank.rows", valid)
    return _rerank_exact(q, rows, valid, x, k=k, metric=metric)


def _host(*ts: torch.Tensor) -> tuple[np.ndarray, ...]:
    with annotate("fdb.to_host"):       # where the host waits for the card
        return tuple(t.cpu().numpy() for t in ts)


class _Stage(NamedTuple):
    """A stage captured as a CUDA graph: its span, the graph, the tensors
    it reads and writes (held for the graph's life), and the counts and
    kernel launches its capture recorded."""
    span: str
    graph: torch.cuda.CUDAGraph
    held: tuple
    counts: list
    launches: dict


class _Graphs:
    """The graph route of a :class:`DeviceIndex` on a CUDA device with the
    bucketed layout. A call's key is its batch's shape and what else fixes
    its shapes and inputs (the index's metric and rotation are the same
    for every key). A key's first call runs op by op; at its next call,
    unless a profiler collects, each stage of its pipeline is captured
    into a CUDA graph of its own, in one memory pool, in full f32, from a
    static batch; then that call and every later one copies the batch in,
    replays each stage's graph inside its span and copies the results
    out, all under the index's lock, so that two threads never share a
    key's buffers; a capture holds the lock too, so the index's other
    graph-route calls wait for it. A replay makes the counts and the
    kernel launches its capture recorded, on this thread alone
    (:func:`.utils.profiling.recording`, :func:`._kernels.recording`; the
    counts on the static tensors, after their stage), so the counters
    and ``_kernels.LAUNCHES`` read as the op-by-op path makes them, and
    another thread's launches during a capture count as it makes them.
    At most :data:`GRAPH_KEYS` keys hold graphs; ``captures`` counts the
    keys captured."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._lock = threading.Lock()
        self._graphs = OrderedDict()    # key → (batch, stages, outputs)
        self._seen = OrderedDict()      # keys called once
        self.captures = 0               # keys captured, evicted ones too

    def replay(self, key, q: np.ndarray, pipeline) -> Optional[tuple]:
        """The host results of ``key``'s graphs on the batch ``q``
        (captured from ``pipeline`` now if the key was seen before), or
        ``None`` where the call runs op by op."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                if key not in self._seen or _profiler_enabled():
                    return None
                del self._seen[key]
                graph = self._graphs[key] = self._capture(np.shape(q),
                                                          pipeline)
                self.captures += 1
                if len(self._graphs) > GRAPH_KEYS:
                    self._graphs.popitem(last=False)
            self._graphs.move_to_end(key)
            count("graph.replays", 1)
            batch, stages, out = graph
            with annotate("fdb.to_device"):
                batch.copy_(torch.as_tensor(
                    np.ascontiguousarray(q, np.float32)))
            for stage in stages:
                with annotate(stage.span):
                    stage.graph.replay()
                    for name, n in stage.counts:
                        count(name, n)
                for name, n in stage.launches.items():
                    _kernels.launched(name, n)
            return _host(*out)

    def seen(self, key) -> None:
        """Notes a call of ``key`` answered op by op."""
        with self._lock:
            self._seen[key] = None
            self._seen.move_to_end(key)
            if len(self._seen) > GRAPH_KEYS:
                self._seen.popitem(last=False)

    def _capture(self, shape: tuple, pipeline) -> tuple:
        """``(batch, stages, outputs)``: ``pipeline(batch, run)`` with
        ``run`` capturing each stage (:func:`_graphed`), the first into a
        memory pool of its own and the rest into the first's, from a
        static ``batch`` of ``shape``."""
        batch = torch.empty(shape, dtype=torch.float32, device=self.device)
        stages = []

        def run(span: str, fn, *args):
            with recording() as counts, _kernels.recording() as launches:
                graph, out = _graphed(fn, args, self.device, stages[0].graph
                                      .pool() if stages else None)
            stages.append(_Stage(span, graph, (args, out), counts, launches))
            return out

        return batch, stages, pipeline(batch, run)


def _graphed(fn, args: tuple, device: torch.device, pool,
             ) -> tuple[torch.cuda.CUDAGraph, object]:
    """``(graph, outputs)``: ``fn(*args)`` captured on ``device`` into a
    CUDA graph that allocates from the memory pool ``pool`` (a new one
    where ``None``), in full f32; no other thread's calls are held to the
    capture's rules."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), full_f32(), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        out = fn(*args)
    return graph, out


class _Index:
    """The body :class:`DeviceIndex` and :class:`ShardedIndex` share: the
    metric, the layout policy, the uploads, the row-mask check and the
    chunk loops of the query and of range search, on one device.
    :class:`ShardedIndex` replaces where the data lives
    (``_place_buckets``, ``_place_rows``, ``_place_mask``, ``_ranks``)
    and how one chunk is answered (``_knn``, ``_candidates``)."""

    _ranks = 1
    #: The graph route (:class:`_Graphs`), where the index takes it.
    _graphs: Optional[_Graphs] = None

    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 codes: np.ndarray, pidx: np.ndarray,
                 layout: Optional[str] = None,
                 rotation: Optional[np.ndarray] = None,
                 hbm_budget_bytes: int = HBM_BUDGET_BYTES,
                 metric: str = "l2",
                 device: str | torch.device = "cuda") -> None:
        self.hbm_budget_bytes = hbm_budget_bytes
        # Cosine is L2 over unit vectors: the database layer normalizes.
        self.metric = "dot" if check_metric(metric) == "dot" else "l2"
        self.device = torch.device(device)
        p = centroids.shape[0]
        if layout is None:
            layout = self._policy(p, np.asarray(codes), np.asarray(pidx))
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout: {layout!r}")
        self.layout = layout
        self.num_rows = len(codes)
        self.centroids = torch.tensor(
            np.asarray(centroids, np.float32), device=self.device)
        self.codebooks = torch.tensor(
            np.asarray(codebooks, np.float32), device=self.device)
        self.rotation = None if rotation is None else torch.tensor(
            np.asarray(rotation, np.float32), device=self.device)
        self.buckets = self.codes = self.pidx = None
        if layout == "bucketed":
            self.buckets = self._place_buckets(bucketize(
                np.asarray(codes, np.int32), np.asarray(pidx, np.int32), p))
        else:
            self.codes, self.pidx = self._place_rows(
                np.asarray(codes, np.int32), np.asarray(pidx, np.int32))

    def _policy(self, p: int, codes: np.ndarray, pidx: np.ndarray) -> str:
        """The layout ``layout=None`` takes: :func:`card_layout` on a CUDA
        device, the JAX package's :func:`.host.choose_layout` elsewhere."""
        if self.device.type != "cuda":
            return choose_layout(p, pidx, max(len(codes), 1))
        memory = torch.cuda.get_device_properties(self.device).total_memory
        counts = np.bincount(pidx.astype(np.int64, copy=False), minlength=p)
        return card_layout(counts, len(codes), codes.shape[1], memory,
                           packs(codes))

    # Where the data lives, and how one chunk is answered: on this device.

    def _place_buckets(self, buckets: Buckets) -> Buckets:
        return Buckets(*(t.to(self.device) for t in buckets))

    def _place_rows(self, codes: np.ndarray, pidx: np.ndarray):
        return (torch.tensor(codes, device=self.device),
                torch.tensor(pidx, device=self.device))

    def _place_mask(self, mask: torch.Tensor) -> torch.Tensor:
        return mask

    def _knn(self, qd: torch.Tensor, mask, run=eager, **kw):
        """One chunk's ``(dists, rows, probed)``; ``run`` runs the bucketed
        pipeline's stages (the masked scan runs op by op)."""
        if self.buckets is not None:
            return _query_block(qd, self.centroids, self.codebooks,
                                self.buckets, mask, 0, run=run, **kw)
        return query_masked_scan(qd, self.centroids, self.codebooks,
                                 self.codes, self.pidx, mask, **kw)

    def _candidates(self, qd: torch.Tensor, mask, **kw):
        if self.buckets is not None:
            return range_bucketed(qd, self.centroids, self.codebooks,
                                  self.buckets, mask, **kw)
        return range_masked_scan(qd, self.centroids, self.codebooks,
                                 self.codes, self.pidx, mask, **kw)

    def _masked_batch_limit(self) -> int:
        """:func:`_masked_limit` at the largest rank's rows, so that every
        rank runs the same chunks."""
        return _masked_limit(tuple(self.centroids.shape),
                             tuple(self.codebooks.shape),
                             -(-self.num_rows // self._ranks),
                             self.hbm_budget_bytes, self.metric)

    def _row_mask(self, row_mask) -> Optional[torch.Tensor]:
        """A numpy or tensor ``[N]`` mask as a bool tensor on this index's
        device (uploaded once a call): whole for the bucketed layout, the
        rows this index holds for the masked one."""
        if row_mask is None:
            return None
        mask = torch.as_tensor(row_mask, dtype=torch.bool, device=self.device)
        if mask.shape != (self.num_rows,):
            raise ValueError(f"row_mask shape {tuple(mask.shape)} != "
                             f"({self.num_rows},)")
        return mask if self.buckets is not None else self._place_mask(mask)

    def _query(self, qd: torch.Tensor, k: int, nprobe: int, row_mask,
               run=eager,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device ``(dists, rows, probed)``; masked batches in chunks."""
        kw = dict(k=k, nprobe=nprobe, metric=self.metric,
                  rotation=self.rotation)
        if self.buckets is not None:
            return self._knn(qd, row_mask, run, **kw)
        with annotate("fdb.to_device"):
            chunks = qd.split(self._masked_batch_limit())
        parts = [self._knn(qc, row_mask, **kw) for qc in chunks]
        with annotate("fdb.topk"):
            return tuple(torch.cat(ts) for ts in zip(*parts))

    def _answer(self, q: np.ndarray, row_mask, pipeline, *key) -> tuple:
        """The host results of ``pipeline(qd, run, mask)`` for the batch
        ``q``: by the graph route where the index takes it and the call has
        no ``row_mask`` (its key: ``q``'s shape and ``key``), else op by op
        (counted on a CUDA device: as ``graph.eager`` where the layout is
        bucketed, as ``serve.masked`` where it is masked)."""
        graphs = self._graphs if row_mask is None and len(q) else None
        if graphs is not None:
            key = (np.shape(q), *key)
            out = graphs.replay(key, q, pipeline)
            if out is not None:
                return out
        if self.device.type == "cuda":
            count("graph.eager" if self.buckets is not None
                  else "serve.masked", 1)
        qd, mask = self._to_device(q, row_mask)
        out = _host(*pipeline(qd, eager, mask))
        if graphs is not None:
            graphs.seen(key)
        return out

    def _to_device(self, q: np.ndarray, row_mask):
        """The query batch and ``row_mask`` on this index's device."""
        with annotate("fdb.to_device"):
            return (torch.as_tensor(np.ascontiguousarray(q, np.float32),
                                    device=self.device),
                    self._row_mask(row_mask))

    @annotated("fdb.index.query")
    def query(self, q: np.ndarray, k: int, nprobe: int, row_mask=None,
              approx: bool | float = False,
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched k-NN: ``q [B, M]`` → host ``(dists, rows, probed)``.
        ``row_mask [N] bool`` (numpy or tensor) excludes the corpus rows
        whose entry is False before the top-k; ``approx`` is answered
        exactly."""
        def knn(qd, run, mask=None):
            return self._query(qd, k, nprobe, mask, run)
        return self._answer(q, row_mask, knn, k, nprobe, None)

    def query_range(self, q: np.ndarray, radius: float, nprobe: int,
                    row_mask=None) -> list:
        """Range search: for each query, ``(rows int64[], keys f32[])`` of
        every probed vector whose ranking key is ``<= radius`` (squared
        distance for L2 and cosine, negated inner product for dot),
        ascending. The device scans; thresholding happens on the host, so
        the whole candidate key array crosses. Query batches run in chunks
        whose transients fit ``hbm_budget_bytes`` (:func:`_range_limit` on
        buckets, :func:`_masked_limit` on the flat layout), each chunk
        thresholded as it arrives."""
        qd = torch.as_tensor(np.ascontiguousarray(q, np.float32),
                             device=self.device)
        mask = self._row_mask(row_mask)
        kw = dict(nprobe=nprobe, metric=self.metric, rotation=self.rotation)
        out = []
        if self.buckets is not None:
            limit = _range_limit(nprobe, self.buckets.codes.shape[2],
                                 tuple(self.codebooks.shape),
                                 self.hbm_budget_bytes)
            for i in range(0, len(qd), limit):
                keys, rows, _ = self._candidates(qd[i:i + limit], mask, **kw)
                out += _range_host_tail(*_host(keys, rows), radius)
            return out
        limit = self._masked_batch_limit()
        for i in range(0, len(qd), limit):
            keys, = _host(self._candidates(qd[i:i + limit], mask, **kw)[0])
            rows = np.broadcast_to(np.arange(keys.shape[1], dtype=np.int32),
                                   keys.shape)
            out += _range_host_tail(keys, rows, radius)
        return out


class DeviceIndex(_Index):
    """IVF-PQ index held on ``device`` (``"cuda"`` by default), ready for
    batched queries. ``layout`` is ``"bucketed"``, ``"masked"`` or ``None``
    (the policy of the device: :func:`card_layout` on a CUDA device, the
    JAX package's elsewhere); ``rotation [M, M]`` is the OPQ rotation
    the codes were made in. On a CUDA device with the bucketed layout it
    takes the graph route (:class:`_Graphs`)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.device.type == "cuda" and self.buckets is not None:
            self._graphs = _Graphs(self.device)

    @annotated("fdb.index.query")
    def query_rerank(self, q: np.ndarray, originals: torch.Tensor, k: int,
                     nprobe: int, rerank: int, row_mask=None,
                     approx: bool | float = False,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """ADC query for the top ``rerank`` candidates, then their EXACT
        re-scoring against ``originals [N, M]`` (on this index's device),
        both on the device: host ``(dists [B, k], rows [B, k])``. Rows that
        ``row_mask`` drops come out of the ADC pass at ``+inf`` and are
        never candidates."""
        def reranked(qd, run, mask=None):
            adc, rows, _ = self._query(qd, rerank, nprobe, mask, run)
            return run("fdb.rerank", _rerank, qd, adc, rows, originals, k,
                       self.metric)
        return self._answer(q, row_mask, reranked, k, nprobe, rerank,
                            id(originals), originals.data_ptr(),
                            tuple(originals.shape), originals.dtype)


class ShardedIndex(_Index):
    """IVF-PQ index sharded over a :class:`.parallel.mesh.CorpusMesh`
    (the JAX package's ``ShardedIndex``): every method is a collective
    call, made by every rank with the same arguments, and returns the same
    host arrays on every rank. Two layouts, as :class:`DeviceIndex`:
    **bucketed** (the buckets split on the partition axis; each rank scans
    only the probed buckets it owns with K-A,
    :mod:`.parallel.bucketed`) or **masked** (the rows split; each rank
    scans all its rows, :mod:`.parallel.query`); ``layout=None`` applies
    the policy of the mesh's device, as :class:`DeviceIndex` does. A query
    moves ``k`` candidates a rank;
    range search moves the candidate arrays. ``self.layout`` is
    ``"sharded-bucketed"`` or ``"sharded-masked"``."""

    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 codes: np.ndarray, pidx: np.ndarray,
                 layout: Optional[str] = None,
                 rotation: Optional[np.ndarray] = None,
                 hbm_budget_bytes: int = HBM_BUDGET_BYTES,
                 metric: str = "l2", *, mesh) -> None:
        self.mesh = mesh
        self._ranks = mesh.size
        super().__init__(centroids, codebooks, codes, pidx, layout,
                         rotation, hbm_budget_bytes, metric, mesh.device)
        self.layout = f"sharded-{self.layout}"

    def _place_buckets(self, buckets: Buckets) -> Buckets:
        return shard_buckets(self.mesh, buckets)

    def _place_rows(self, codes: np.ndarray, pidx: np.ndarray):
        return shard_corpus(self.mesh, codes, pidx)

    def _place_mask(self, mask: torch.Tensor) -> torch.Tensor:
        return shard_mask(self.mesh, mask)

    def _knn(self, qd: torch.Tensor, mask, run=eager, **kw):
        """The mesh's chunk, op by op (``run`` is always :func:`eager`
        here: a mesh has no graph route)."""
        if self.buckets is not None:
            return query_bucketed_sharded(qd, self.centroids, self.codebooks,
                                          self.buckets, mask, mesh=self.mesh,
                                          **kw)
        return query_sharded(qd, self.centroids, self.codebooks, self.codes,
                             self.pidx, mask, mesh=self.mesh,
                             n=self.num_rows, **kw)

    def _candidates(self, qd: torch.Tensor, mask, **kw):
        if self.buckets is not None:
            return range_bucketed_sharded(
                qd, self.centroids, self.codebooks, self.buckets, mask,
                mesh=self.mesh, **kw)
        return range_sharded(qd, self.centroids, self.codebooks, self.codes,
                             self.pidx, mask, mesh=self.mesh,
                             n=self.num_rows, **kw)
