"""Database builder and in-memory database (the JAX package's
``build.py``, ``build.rs``).

The build runs on an explicit device, ``"cuda"`` unless asked otherwise:

1. coarse k-means++ / Lloyd over ``[N, M]`` (:mod:`.partitions`),
2. residues, divided into ``[D, N, M/D]``,
3. the ``D`` division codebooks trained as one batched fit, or, with
   ``with_opq``, an OPQ rotation and the codebooks of the rotated
   residuals (:mod:`.ops.opq`).

Every Lloyd round is kernel K-B, or K-C for PQ subvector widths below 128
that divide it (their ``fast_math`` variants under ``with_fast_math``);
every query's bucket scan is kernel K-A.
``DatabaseBuilder(x, np.float64)`` trains on the host instead, in f64,
through :mod:`.oracle` (the JAX package's f64 route), and serves f32.
The :class:`Database` keeps the JAX package's numpy fields, so
:mod:`.convert` carries a database across in either direction, and the
same ``with_seed`` gives the same ``vector_ids`` in both packages.
"""

from __future__ import annotations

import uuid as _uuid
import warnings
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import events as ev
from . import oracle
from .attributes import AttributeValue, check_attribute_value
from .errors import InvalidArgs
from .events import EventHandler, _noop
from .host import as_vector_set, check_metric, check_range_args, \
    normalize_rows
from .ops import kmeans
from .partitions import partition
from .utils.profiling import annotate, annotated


def _make_uuids(n: int, rng: np.random.Generator) -> List[_uuid.UUID]:
    """Random version-4 UUIDs (``build.rs:86-91``), reproducible via rng."""
    raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40  # version 4
    raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80  # RFC 4122 variant
    return [_uuid.UUID(bytes=row.tobytes()) for row in raw]


def _local_indices(pidx: np.ndarray, p: int) -> np.ndarray:
    """Rank of each vector inside its partition, in input order
    (``build.rs:462-472, 546-562``)."""
    order = np.argsort(pidx, kind="stable")
    sorted_p = pidx[order]
    starts = np.searchsorted(sorted_p, np.arange(p), side="left")
    local = np.empty(len(pidx), dtype=np.int32)
    local[order] = np.arange(len(pidx), dtype=np.int32) - starts[sorted_p]
    return local


@dataclass
class QueryResult:
    """One k-NN result (``build.rs:576-587``)."""
    partition_index: int
    vector_id: _uuid.UUID
    vector_index: int          # local index within the partition
    squared_distance: float


class DatabaseBuilder:
    """Fluent builder (``build.rs:23-70``); defaults P=10, D=8, C=16.

    ``device`` is where the build runs and the database serves from:
    ``"cuda"`` by default, ``"cpu"`` only when asked for (the kernels'
    plain versions then run).

    ``dtype=np.float64`` trains on the host in f64 through :mod:`.oracle`,
    as the JAX package's f64 route does (the same draws, events and
    errors, so the same seed gives the JAX package's f64 database array
    for array); the database then serves from f32 arrays on ``device``,
    cast with an overflow check (:class:`InvalidArgs`). Fast math and OPQ
    raise :class:`InvalidArgs` there."""

    def __init__(self, vs, dtype=np.float32,
                 device: str | torch.device = "cuda") -> None:
        dt = np.dtype(dtype)
        if dt == np.float64:
            arr = np.asarray(vs, np.float64)
            if arr.ndim != 2:
                raise InvalidArgs(
                    f"f64 build needs an [N, M] array, got {arr.shape}")
            self._vs = arr
        elif dt == np.float32:
            self._vs = as_vector_set(vs)
        else:
            raise InvalidArgs(f"unsupported build dtype: {dt}")
        self._dtype = dt.type
        self._device = torch.device(device)
        self._num_partitions = 10
        self._num_divisions = 8
        self._num_clusters = 16
        self._seed: Optional[int] = None
        self._metric = "l2"
        self._keep_residues = True
        self._impl: Optional[str] = None
        self._opq_iters = 0

    def with_partitions(self, p: int) -> "DatabaseBuilder":
        if p <= 0:
            raise InvalidArgs(f"num_partitions must be positive: {p}")
        self._num_partitions = p
        return self

    def with_divisions(self, d: int) -> "DatabaseBuilder":
        if d <= 0:
            raise InvalidArgs(f"num_divisions must be positive: {d}")
        self._num_divisions = d
        return self

    def with_clusters(self, c: int) -> "DatabaseBuilder":
        if c <= 0:
            raise InvalidArgs(f"num_clusters must be positive: {c}")
        self._num_clusters = c
        return self

    def with_opq(self, iters: int = 8) -> "DatabaseBuilder":
        """Learns an orthogonal rotation before PQ (:mod:`.ops.opq`), with
        ``iters`` alternations: lower quantization error at equal code
        memory. The codes live in the rotated space; queries rotate their
        residuals (``Database.rotation``)."""
        if iters <= 0:
            raise InvalidArgs(f"opq iters must be positive: {iters}")
        self._opq_iters = iters
        return self

    def with_metric(self, metric: str) -> "DatabaseBuilder":
        """``"l2"`` (default), ``"dot"`` or ``"cosine"``, as in the JAX
        package's ``metrics``."""
        self._metric = check_metric(metric)
        return self

    def with_fast_math(self, on: bool = True) -> "DatabaseBuilder":
        """Trains with ``fast_math`` numerics: every Lloyd round of the
        coarse and PQ fits (OPQ's too) takes one bf16 pass
        (:mod:`.ops.lloyd`, the ``"_fast"`` impl). Queries keep full f32.
        """
        self._impl = "_fast" if on else None
        return self

    def with_seed(self, seed: int) -> "DatabaseBuilder":
        """Fixes the clustering RNG and the UUIDs (the same ids as the JAX
        package for the same seed)."""
        self._seed = seed
        return self

    def with_residues(self, keep: bool = True) -> "DatabaseBuilder":
        """Whether the built database retains per-vector residues (``N·M·4``
        bytes of host memory and a device-to-host copy in :meth:`build`).
        They back :meth:`Database.reconstruct` and ``query_batch(rerank=)``;
        without them both raise :class:`InvalidArgs`."""
        self._keep_residues = keep
        return self

    def build_with_events(self, events: EventHandler) -> "Database":
        return self.build(events)

    def build(self, events: EventHandler = _noop) -> "Database":
        """Runs the build pipeline (``build.rs:78-129``)."""
        x = self._vs
        if self._metric == "cosine":
            x = normalize_rows(x)
        n, m = x.shape
        p, d, c = (self._num_partitions, self._num_divisions,
                   self._num_clusters)
        if n < p:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {p}")
        if n < c:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {c}")
        if m % d != 0:
            raise InvalidArgs(f"vector size ({m}) is not divisible by {d}")

        seed = (np.random.SeedSequence().entropy if self._seed is None
                else self._seed)
        rng = np.random.default_rng(seed)
        # The same draw, in the same order, as the JAX package's jax key:
        # it leaves rng where that build leaves it for the UUIDs.
        key = int(np.uint32(rng.integers(0, 2**32)))
        g_coarse = torch.Generator(self._device).manual_seed(key)
        g_pq = torch.Generator(self._device).manual_seed(key + 2**32)

        events(ev.StartingIdAssignment())
        vector_ids = _make_uuids(n, rng)
        events(ev.FinishedIdAssignment())

        if self._dtype == np.float64:
            if self._impl is not None:
                raise InvalidArgs(
                    "with_fast_math() is not supported for dtype=float64 "
                    "(the host oracle is exact by design)")
            return self._build_f64(x, p, d, c, rng, vector_ids, events)

        events(ev.StartingPartitioning())
        cluster_events = ((lambda e: events(ev.ClusterEvent(e)))
                          if events is not _noop else _noop)
        xd = torch.as_tensor(x, device=self._device)
        parts = partition(xd, p, g_coarse, events=cluster_events,
                          impl=self._impl)
        del xd
        events(ev.FinishedPartitioning())

        events(ev.StartingSubvectorDivision())
        # OPQ divides the rotated residuals itself.
        divided = None if self._opq_iters else parts.residues.reshape(
            n, d, m // d).transpose(0, 1).contiguous()       # [D, N, m]
        events(ev.FinishedSubvectorDivision())

        # All D codebooks train in one batched fit; the JAX package emits
        # the per-division event pairs around it, and no cluster events
        # from inside OPQ.
        for i in range(d):
            events(ev.StartingQuantization(i))
        rotation = None
        if self._opq_iters:
            from .ops.opq import fit_opq
            opq = fit_opq(parts.residues, d, c, g_pq, iters=self._opq_iters,
                          impl=self._impl)
            rotation, pq = opq.rotation.cpu().numpy(), opq.pq
        else:
            pq = kmeans.fit(divided, c, g_pq, handler=cluster_events,
                            impl=self._impl)
        del divided
        for i in range(d):
            events(ev.FinishedQuantization(i))

        return Database(
            vector_size=m,
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=parts.centroids.cpu().numpy(),
            partition_indices=parts.indices.cpu().numpy().astype(np.int32),
            codebooks=pq.centroids.cpu().numpy(),
            codes=pq.indices.T.cpu().numpy().astype(np.uint32),
            residues=(parts.residues.cpu().numpy()
                      if self._keep_residues else None),
            rotation=rotation,
            metric=self._metric,
            device=str(self._device),
        )

    def _build_f64(self, x, p, d, c, rng, vector_ids,
                   events: EventHandler) -> "Database":
        """The f64 build (the JAX package's ``_build_f64``): training runs
        in f64 on the host (``oracle.build``), then the serving arrays cast
        to f32 with an overflow check, since the device path and the wire
        format (``database.proto:66-72``) are f32."""
        if self._opq_iters:
            raise InvalidArgs("OPQ is not supported on the f64 build path")

        events(ev.StartingPartitioning())
        ob = oracle.build(x, p, d, c, rng, dtype=np.float64)
        events(ev.FinishedPartitioning())
        events(ev.StartingSubvectorDivision())
        residues64 = x - ob.partition_centroids[ob.partition_indices]
        events(ev.FinishedSubvectorDivision())
        for i in range(d):
            events(ev.StartingQuantization(i))
            events(ev.FinishedQuantization(i))

        def cast32(a, what):
            with np.errstate(over="ignore"), warnings.catch_warnings():
                # Overflow is detected and reported as InvalidArgs below.
                warnings.simplefilter("ignore", RuntimeWarning)
                out = a.astype(np.float32)
            if np.isinf(out[np.isfinite(a)]).any():
                raise InvalidArgs(
                    f"f64 {what} overflows f32 serving range")
            return out

        return Database(
            vector_size=x.shape[1],
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=cast32(ob.partition_centroids,
                                       "partition centroids"),
            partition_indices=np.asarray(ob.partition_indices, np.int32),
            codebooks=cast32(ob.codebooks, "codebooks"),
            codes=np.asarray(ob.codes, np.uint32),
            residues=(cast32(residues64, "residues")
                      if self._keep_residues else None),
            rotation=None,
            metric=self._metric,
            device=str(self._device),
        )


@dataclass
class Database:
    """In-memory database (``build.rs:156-286``): the JAX package's numpy
    fields, served from a device index built at the first query (and
    again after :meth:`add_vectors` or :meth:`remove_vectors`)."""
    vector_size: int
    num_partitions: int
    num_divisions: int
    num_clusters: int
    vector_ids: List[_uuid.UUID]
    partition_centroids: np.ndarray          # [P, M] f32
    partition_indices: np.ndarray            # [N] int32
    codebooks: np.ndarray                    # [D, C, m] f32
    codes: np.ndarray                        # [N, D] uint32
    residues: Optional[np.ndarray] = None    # [N, M] f32
    rotation: Optional[np.ndarray] = None    # [M, M] f32 OPQ rotation
    metric: str = "l2"
    attribute_table: dict = field(default_factory=dict)
    device: str = "cuda"

    _local_idx: Optional[np.ndarray] = field(default=None, repr=False)
    _dev: Optional[object] = field(default=None, repr=False)
    _dev_orig: Optional[torch.Tensor] = field(default=None, repr=False)
    _filter_cache: Optional[object] = field(default=None, repr=False)

    @property
    def num_vectors(self) -> int:
        return len(self.vector_ids)

    @property
    def subvector_size(self) -> int:
        return self.vector_size // self.num_divisions

    @property
    def local_indices(self) -> np.ndarray:
        if self._local_idx is None:
            self._local_idx = _local_indices(
                self.partition_indices, self.num_partitions)
        return self._local_idx

    def reconstruct(self, i: int) -> np.ndarray:
        """Input vector i = residue + centroid (``partitions.rs:68-93``)."""
        if self.residues is None:
            raise InvalidArgs("residues were not retained")
        return (self.residues[i]
                + self.partition_centroids[self.partition_indices[i]])

    # -- updates (the JAX package's build.py:417-491) ------------------------

    def add_vectors(self, vs,
                    vector_ids: Optional[List[_uuid.UUID]] = None,
                    seed: Optional[int] = None) -> List[_uuid.UUID]:
        """Adds vectors without retraining: each goes to its nearest
        partition and is PQ-encoded with the existing codebooks
        (:func:`.ops.encode.encode`, on this database's device; in the
        rotated space under OPQ). New ids
        come from ``seed`` as the JAX package draws them. The next query
        rebuilds the device index."""
        from .ops.encode import encode

        x = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            x = normalize_rows(x)
        if vector_ids is None:
            vector_ids = _make_uuids(len(x), np.random.default_rng(seed))
        if len(vector_ids) != len(x):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(x)} vectors")
        pidx, codes = (t.cpu().numpy() for t in encode(
            torch.tensor(x, device=self.device),
            torch.tensor(self.partition_centroids, device=self.device),
            torch.tensor(self.codebooks, device=self.device),
            None if self.rotation is None else torch.tensor(
                self.rotation, device=self.device)))
        self.partition_indices = np.concatenate(
            [self.partition_indices, pidx.astype(np.int32)])
        self.codes = np.concatenate([self.codes, codes.astype(np.uint32)])
        if self.residues is not None:
            res = x - self.partition_centroids[pidx]
            self.residues = np.concatenate([self.residues, res])
        self.vector_ids.extend(vector_ids)
        self._changed()
        return list(vector_ids)

    def remove_vectors(self, vector_ids: Iterable[_uuid.UUID]) -> int:
        """Removes vectors, and their attributes, by id; returns the number
        removed. An unknown id raises :class:`InvalidArgs`."""
        doomed = set(vector_ids)
        if not doomed:
            return 0
        row_of = {vid: i for i, vid in enumerate(self.vector_ids)}
        missing = [vid for vid in doomed if vid not in row_of]
        if missing:
            raise InvalidArgs(f"no such vector ID: {missing[0]}")
        keep = np.ones(self.num_vectors, bool)
        keep[[row_of[vid] for vid in doomed]] = False
        self.vector_ids = [vid for vid, kp in zip(self.vector_ids, keep)
                           if kp]
        self.partition_indices = self.partition_indices[keep]
        self.codes = self.codes[keep]
        if self.residues is not None:
            self.residues = self.residues[keep]
        for vid in doomed:
            self.attribute_table.pop(vid, None)
        self._changed()
        return len(doomed)

    def _changed(self) -> None:
        """Drops what was derived from the rows: the device index, the
        originals on the device, the local indices and the filter
        columns."""
        self._dev = None
        self._dev_orig = None
        self._local_idx = None
        self._invalidate_filters()

    # -- attributes (build.rs:228-285) --------------------------------------

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        try:
            attrs = self.attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    def set_attribute_at(self, i: int, attribute: Tuple[str, AttributeValue],
                         ) -> None:
        if not 0 <= i < self.num_vectors:
            raise InvalidArgs(f"vector index out of bounds: {i}")
        key, value = attribute
        value = check_attribute_value(value)
        vid = self.vector_ids[i]
        self.attribute_table.setdefault(vid, {})[str(key)] = value
        self._invalidate_filters()     # the cached columns are stale now

    # -- attribute filters (the JAX package's build.py:513-524) -------------

    def _invalidate_filters(self) -> None:
        if self._filter_cache is not None:
            self._filter_cache.invalidate()

    def _filter_mask(self, where) -> Optional[np.ndarray]:
        """``where`` evaluated on the host to a bool row mask ``[N]``
        (:mod:`.filters`; columns cached until the rows or attributes
        change), or ``None`` for no filter."""
        from .filters import ColumnCache, evaluate_mask
        if where is None:
            return None
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        return evaluate_mask(where, self.vector_ids, self.attribute_table,
                             self._filter_cache)

    # -- queries (build.rs:293-382) ------------------------------------------

    def _device_state(self):
        if self._dev is None:
            from .serving import DeviceIndex
            self._dev = DeviceIndex(
                self.partition_centroids, self.codebooks,
                self.codes.astype(np.int32), self.partition_indices,
                rotation=self.rotation, metric=self.metric,
                device=self.device)
        return self._dev

    def _device_originals(self) -> torch.Tensor:
        """The input vectors, ``residues + centroids[pidx]``, kept on the
        device for exact rerank."""
        if self._dev_orig is None:
            self._dev_orig = torch.as_tensor(
                self.residues
                + self.partition_centroids[self.partition_indices],
                device=self.device)
        return self._dev_orig

    def _prep_queries(self, vs: np.ndarray) -> np.ndarray:
        if self.metric == "cosine":
            return normalize_rows(vs, "query")
        return vs

    def query(self, v, k: int, nprobe: int,
              where=None) -> List[QueryResult]:
        return self.query_with_events(v, k, nprobe, _noop, where=where)

    def query_with_events(self, v, k: int, nprobe: int,
                          events: EventHandler,
                          where=None) -> List[QueryResult]:
        """Single-vector k-NN (``build.rs:307-340``). ``where`` (a
        :class:`.filters.Filter`) keeps only the vectors whose attributes
        satisfy it: the k nearest matching vectors in the probed
        partitions."""
        self._validate_query(k, nprobe)
        v = np.asarray(v, dtype=np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        v = self._prep_queries(v)
        mask = self._filter_mask(where)
        events(ev.StartingPartitionSelection())
        dists, rows, probed = self._device_state().query(v, k, nprobe,
                                                         row_mask=mask)
        dists, rows, probed = dists[0], rows[0], probed[0]
        events(ev.FinishedPartitionSelection())
        for pi in probed:
            events(ev.StartingPartitionQuery(int(pi)))
            events(ev.FinishedPartitionQuery(int(pi)))
        events(ev.StartingResultSelection())
        results = self._to_results(dists, rows)
        events(ev.FinishedResultSelection())
        return results

    @annotated("fdb.query_batch")
    def query_batch(self, vs, k: int, nprobe: int,
                    rerank: Optional[int] = None,
                    where=None) -> List[List[QueryResult]]:
        """Batched k-NN, one device pass for all queries.

        ``rerank``: re-score the top ``rerank`` (>= k) ADC candidates with
        exact distances against the original vectors (``residues +
        centroids``, kept on the device) and return the best ``k``.
        ``where``: an attribute filter, applied before the top-k (so before
        rerank: every candidate matches)."""
        self._validate_query(k, nprobe)
        vs = as_vector_set(vs)
        if vs.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {vs.shape[1]} != {self.vector_size}")
        vs = self._prep_queries(vs)
        mask = self._filter_mask(where)
        if rerank is None:
            dists, rows, _ = self._device_state().query(vs, k, nprobe,
                                                        row_mask=mask)
        else:
            if rerank < k:
                raise InvalidArgs(f"rerank ({rerank}) must be >= k ({k})")
            if self.residues is None:
                raise InvalidArgs("rerank requires retained residues")
            dists, rows = self._device_state().query_rerank(
                vs, self._device_originals(), k=k, nprobe=nprobe,
                rerank=rerank, row_mask=mask)
        with annotate("fdb.results"):
            return [self._to_results(dists[b], rows[b])
                    for b in range(len(vs))]

    def query_range(self, v, radius: float, nprobe: int,
                    limit: Optional[int] = None,
                    where=None) -> List[QueryResult]:
        """Range search: every vector in the ``nprobe`` nearest partitions
        whose ranking key is ``<= radius``, ascending. The key is what
        ``QueryResult.squared_distance`` reports: squared L2 for l2 and
        cosine (``2 − 2·cos``), the negated inner product for dot.
        ``limit`` keeps the nearest ``limit``; ``where`` filters on
        attributes."""
        check_range_args(radius, nprobe, self.num_partitions)
        v = np.asarray(v, dtype=np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        v = self._prep_queries(v)
        mask = self._filter_mask(where)
        (rows, keys), = self._device_state().query_range(
            v, radius, nprobe, row_mask=mask)
        if limit is not None:
            rows, keys = rows[:limit], keys[:limit]
        local = self.local_indices
        return [QueryResult(partition_index=int(self.partition_indices[r]),
                            vector_id=self.vector_ids[r],
                            vector_index=int(local[r]),
                            squared_distance=float(key))
                for r, key in zip(rows.tolist(), keys.tolist())]

    def _validate_query(self, k: int, nprobe: int) -> None:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        if nprobe <= 0:
            raise InvalidArgs(f"nprobe must be positive: {nprobe}")
        if nprobe > self.num_partitions:
            raise InvalidArgs(
                f"nprobe {nprobe} exceeds the number of partitions"
                f" {self.num_partitions}")

    def _to_results(self, dists: np.ndarray,
                    rows: np.ndarray) -> List[QueryResult]:
        local = self.local_indices
        out: List[QueryResult] = []
        for dist, row in zip(dists, rows):
            if not np.isfinite(dist):
                break  # fewer reachable vectors than k
            out.append(QueryResult(
                partition_index=int(self.partition_indices[row]),
                vector_id=self.vector_ids[row],
                vector_index=int(local[row]),
                squared_distance=float(dist),
            ))
        return out
