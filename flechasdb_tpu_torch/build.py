"""Database builder and in-memory database (the JAX package's
``build.py``, ``build.rs``).

The build runs on an explicit device, ``"cuda"`` unless asked otherwise:

1. coarse k-means++ / Lloyd over ``[N, M]`` (:mod:`.partitions`),
2. residues, divided into ``[D, N, M/D]``,
3. the ``D`` division codebooks trained as one batched fit.

Every Lloyd round is kernel K-B, or K-C for PQ subvector widths below 128
that divide it; every query's bucket scan is kernel K-A.
The :class:`Database` keeps the JAX package's numpy fields, so
:mod:`.convert` carries a database across in either direction, and the
same ``with_seed`` gives the same ``vector_ids`` in both packages.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import events as ev
from ._roadmap import not_ported
from .errors import InvalidArgs
from .events import EventHandler, _noop
from .host import as_vector_set, check_metric, normalize_rows
from .ops import kmeans
from .partitions import partition


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
    plain versions then run)."""

    def __init__(self, vs, dtype=np.float32,
                 device: str | torch.device = "cuda") -> None:
        dt = np.dtype(dtype)
        if dt == np.float64:
            raise not_ported("The float64 build", 14)
        if dt != np.float32:
            raise InvalidArgs(f"unsupported build dtype: {dt}")
        self._vs = as_vector_set(vs)
        self._device = torch.device(device)
        self._num_partitions = 10
        self._num_divisions = 8
        self._num_clusters = 16
        self._seed: Optional[int] = None
        self._metric = "l2"
        self._keep_residues = True

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
        raise not_ported("with_opq", 13)

    def with_metric(self, metric: str) -> "DatabaseBuilder":
        """``"l2"`` (default), ``"dot"`` or ``"cosine"``, as in the JAX
        package's ``metrics``."""
        self._metric = check_metric(metric)
        return self

    def with_fast_math(self, on: bool = True) -> "DatabaseBuilder":
        if on:
            raise not_ported("with_fast_math", 12)
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

        events(ev.StartingPartitioning())
        cluster_events = ((lambda e: events(ev.ClusterEvent(e)))
                          if events is not _noop else _noop)
        xd = torch.as_tensor(x, device=self._device)
        parts = partition(xd, p, g_coarse, events=cluster_events)
        del xd
        events(ev.FinishedPartitioning())

        events(ev.StartingSubvectorDivision())
        divided = parts.residues.reshape(n, d, m // d).transpose(0, 1) \
            .contiguous()                                   # [D, N, m]
        events(ev.FinishedSubvectorDivision())

        for i in range(d):
            events(ev.StartingQuantization(i))
        pq = kmeans.fit(divided, c, g_pq, handler=cluster_events)
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
            metric=self._metric,
            device=str(self._device),
        )


@dataclass
class Database:
    """In-memory database (``build.rs:156-286``): the JAX package's numpy
    fields, served from a device index built at the first query."""
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
    rotation: Optional[np.ndarray] = None    # OPQ: not ported
    metric: str = "l2"
    attribute_table: dict = field(default_factory=dict)
    device: str = "cuda"

    _local_idx: Optional[np.ndarray] = field(default=None, repr=False)
    _dev: Optional[object] = field(default=None, repr=False)
    _dev_orig: Optional[torch.Tensor] = field(default=None, repr=False)

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

    def add_vectors(self, vs, vector_ids=None, seed=None):
        raise not_ported("add_vectors", 15)

    def remove_vectors(self, vector_ids):
        raise not_ported("remove_vectors", 15)

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
        """Single-vector k-NN (``build.rs:307-340``)."""
        if where is not None:
            raise not_ported("where= (attribute filters)", 10)
        self._validate_query(k, nprobe)
        v = np.asarray(v, dtype=np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        v = self._prep_queries(v)
        events(ev.StartingPartitionSelection())
        dists, rows, probed = self._device_state().query(v, k, nprobe)
        dists, rows, probed = dists[0], rows[0], probed[0]
        events(ev.FinishedPartitionSelection())
        for pi in probed:
            events(ev.StartingPartitionQuery(int(pi)))
            events(ev.FinishedPartitionQuery(int(pi)))
        events(ev.StartingResultSelection())
        results = self._to_results(dists, rows)
        events(ev.FinishedResultSelection())
        return results

    def query_batch(self, vs, k: int, nprobe: int,
                    rerank: Optional[int] = None,
                    where=None) -> List[List[QueryResult]]:
        """Batched k-NN, one device pass for all queries.

        ``rerank``: re-score the top ``rerank`` (>= k) ADC candidates with
        exact distances against the original vectors (``residues +
        centroids``, kept on the device) and return the best ``k``."""
        if where is not None:
            raise not_ported("where= (attribute filters)", 10)
        self._validate_query(k, nprobe)
        vs = as_vector_set(vs)
        if vs.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {vs.shape[1]} != {self.vector_size}")
        vs = self._prep_queries(vs)
        if rerank is None:
            dists, rows, _ = self._device_state().query(vs, k, nprobe)
        else:
            if rerank < k:
                raise InvalidArgs(f"rerank ({rerank}) must be >= k ({k})")
            if self.residues is None:
                raise InvalidArgs("rerank requires retained residues")
            dists, rows = self._device_state().query_rerank(
                vs, self._device_originals(), k=k, nprobe=nprobe,
                rerank=rerank)
        return [self._to_results(dists[b], rows[b]) for b in range(len(vs))]

    def query_range(self, v, radius: float, nprobe: int,
                    limit: Optional[int] = None, where=None):
        raise not_ported("query_range", 11)

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
