"""Streaming build: corpora larger than device memory and host RAM (the
JAX package's ``streaming.py``).

:class:`StreamingDatabaseBuilder` takes a *source*, anything with
``.shape`` and row slicing (``src[lo:hi]``): ``np.ndarray``,
``np.memmap``, h5py and zarr datasets. It reads the source twice:

* once for one training sample of uniform rows, capped by rows
  (:data:`.parallel.build.COARSE_TRAIN_CAP`, ``PQ_TRAIN_CAP``) and by
  bytes (:data:`SAMPLE_BYTES`), gathered in sorted order; the coarse fit
  (``ops.kmeans.fit``) and the PQ fit (or ``ops.opq.fit_opq``) train on
  it, on the builder's device;
* once in chunks of :data:`CHUNK_BYTES` for the encode, the only pass
  over the full corpus: each chunk goes to the device and through
  ``ops.encode.encode`` (nearest partition, then the residual's codes,
  cuBLAS in full f32), the last chunk zero-padded to the same shape.

:meth:`StreamingDatabaseBuilder.with_mesh` shards the encode over a
:class:`.parallel.mesh.CorpusMesh` (a collective build, every rank the
same source and settings): rank 0 trains and broadcasts the centroids,
codebooks and rotation (exact copies); each rank reads and encodes its
block of each chunk, blocks whole :data:`.ops.distance.ASSIGN_CHUNK` row
units, so its products are the very ones the unsharded encode runs on
those rows; the codes are gathered, bit-identical to the unsharded
build's.

Host state is O(N) only in ids and codes. The result is a regular
:class:`.build.Database` with ``residues=None``: ``reconstruct`` and
``rerank=`` raise :class:`InvalidArgs`. The numpy ``rng`` draws in the
JAX package's order (the key, the UUIDs, the sample rows, the
sub-sample permutations), so the same seed gives the same vector ids and
reads the same rows of the source; the fits draw from ``torch.Generator``
seeded from that key, as :class:`.build.DatabaseBuilder` seeds them.
"""

from __future__ import annotations

from typing import Optional, TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:                                # annotation-only import
    from .build import Database

from . import events as ev
from .errors import InvalidArgs
from .events import EventHandler, _noop
from .ops.distance import ASSIGN_CHUNK
from .parallel.build import COARSE_TRAIN_CAP, PQ_TRAIN_CAP
from .parallel.mesh import block_sizes, broadcast, gather_blocks

#: Byte budget of the training sample (raw f32 rows): at M=1536 about
#: 175k rows, at M=96 the row caps bind first.
SAMPLE_BYTES = 1 << 30

#: Byte budget of one streamed encode chunk (host rows sent to the device
#: at once).
CHUNK_BYTES = 256 << 20


def _gather_rows(source, rows: np.ndarray, m: int) -> np.ndarray:
    """``source[rows]`` (rows sorted, unique) as an f32 array: fancy row
    indexing where the source takes it (``np.memmap`` reads only the
    touched pages), else one contiguous read a run of consecutive rows."""
    try:
        return np.asarray(source[rows], dtype=np.float32)
    except (TypeError, IndexError, NotImplementedError):
        out = np.empty((len(rows), m), np.float32)
        i = 0
        while i < len(rows):
            j = i + 1
            while j < len(rows) and rows[j] == rows[j - 1] + 1:
                j += 1
            out[i:j] = source[int(rows[i]):int(rows[j - 1]) + 1]
            i = j
        return out


class StreamingDatabaseBuilder:
    """Fluent builder over an out-of-core corpus source.

    Mirrors :class:`.build.DatabaseBuilder` (defaults P=10, D=8, C=16,
    ``build.rs:44-52``; ``device``, ``"cuda"`` unless asked otherwise,
    is where the fits and the encode run and the database serves from)
    but takes a source instead of an array.

    >>> corpus = np.lib.format.open_memmap("vectors.npy")
    >>> db = (StreamingDatabaseBuilder(corpus)
    ...       .with_partitions(4096).with_divisions(8)
    ...       .with_clusters(256).with_seed(7).build())
    """

    def __init__(self, source, device: str | torch.device = "cuda") -> None:
        shape = getattr(source, "shape", None)
        if shape is None:
            source = np.asarray(source, np.float32)
            shape = source.shape
        if len(shape) != 2 or shape[0] == 0 or shape[1] == 0:
            raise InvalidArgs(
                f"streamed build needs a non-empty [N, M] source, "
                f"got shape {tuple(shape)}")
        self._source = source
        self._device = torch.device(device)
        self._n, self._m = int(shape[0]), int(shape[1])
        self._num_partitions = 10
        self._num_divisions = 8
        self._num_clusters = 16
        self._seed: Optional[int] = None
        self._impl: Optional[str] = None
        self._opq_iters = 0
        self._coarse_cap = COARSE_TRAIN_CAP
        self._pq_cap = PQ_TRAIN_CAP
        self._sample_bytes = SAMPLE_BYTES
        self._chunk_rows: Optional[int] = None
        self._metric = "l2"
        self._mesh = None

    def with_partitions(self, p: int) -> "StreamingDatabaseBuilder":
        if p <= 0:
            raise InvalidArgs(f"num_partitions must be positive: {p}")
        self._num_partitions = p
        return self

    def with_divisions(self, d: int) -> "StreamingDatabaseBuilder":
        if d <= 0:
            raise InvalidArgs(f"num_divisions must be positive: {d}")
        self._num_divisions = d
        return self

    def with_clusters(self, c: int) -> "StreamingDatabaseBuilder":
        if c <= 0:
            raise InvalidArgs(f"num_clusters must be positive: {c}")
        self._num_clusters = c
        return self

    def with_fast_math(self, on: bool = True) -> "StreamingDatabaseBuilder":
        """``fast_math`` numerics in both fits (as
        :meth:`.build.DatabaseBuilder.with_fast_math`)."""
        self._impl = "_fast" if on else None
        return self

    def with_seed(self, seed: int) -> "StreamingDatabaseBuilder":
        """Fixes the sample, the clustering and the UUIDs."""
        self._seed = seed
        return self

    def with_opq(self, iters: int = 8) -> "StreamingDatabaseBuilder":
        """An OPQ rotation trained on the residual sample (see
        :meth:`.build.DatabaseBuilder.with_opq`)."""
        if iters <= 0:
            raise InvalidArgs(f"opq iters must be positive: {iters}")
        self._opq_iters = iters
        return self

    def with_metric(self, metric: str) -> "StreamingDatabaseBuilder":
        """The query metric. Cosine normalizes every row as it streams
        (training sample and encode chunks alike); a zero row raises
        :class:`InvalidArgs` when it streams past."""
        from .host import check_metric
        self._metric = check_metric(metric)
        return self

    def with_training_caps(self, *, coarse_cap: Optional[int] = None,
                           pq_cap: Optional[int] = None,
                           sample_bytes: Optional[int] = None,
                           ) -> "StreamingDatabaseBuilder":
        """Overrides the training sample's budgets (rows and bytes)."""
        if coarse_cap is not None:
            if coarse_cap <= 0:
                raise InvalidArgs(f"coarse_cap must be positive: {coarse_cap}")
            self._coarse_cap = coarse_cap
        if pq_cap is not None:
            if pq_cap <= 0:
                raise InvalidArgs(f"pq_cap must be positive: {pq_cap}")
            self._pq_cap = pq_cap
        if sample_bytes is not None:
            if sample_bytes <= 0:
                raise InvalidArgs(
                    f"sample_bytes must be positive: {sample_bytes}")
            self._sample_bytes = sample_bytes
        return self

    def with_chunk_rows(self, rows: int) -> "StreamingDatabaseBuilder":
        """Overrides the streamed encode's chunk size (rows)."""
        if rows <= 0:
            raise InvalidArgs(f"chunk_rows must be positive: {rows}")
        self._chunk_rows = rows
        return self

    def with_mesh(self, mesh) -> "StreamingDatabaseBuilder":
        """Shards the streamed encode over a
        :class:`.parallel.mesh.CorpusMesh` (extension; see the module
        docstring). :meth:`build` becomes a collective call; training
        stays on rank 0, and the database every rank gets lives on the
        mesh's device."""
        self._mesh = mesh
        return self

    def _train(self, rows: np.ndarray, rng, key: int, s_coarse: int,
               s_pq: int, events: EventHandler, dev: torch.device):
        """The fits on the sample ``rows`` of the source: ``(centroids [P,
        M], codebooks [D, C, M/D], rotation [M, M] or None)``, the tensors
        on ``dev``."""
        from .host import normalize_rows
        from .ops import kmeans
        from .ops.distance import assign_chunked

        m = self._m
        p, d, c = (self._num_partitions, self._num_divisions,
                   self._num_clusters)
        g_coarse = torch.Generator(dev).manual_seed(key)
        g_pq = torch.Generator(dev).manual_seed(key + 2 ** 32)
        sample = _gather_rows(self._source, rows, m)
        if self._metric == "cosine":
            sample = normalize_rows(sample)
        s_have = len(sample)

        cluster_events = ((lambda e: events(ev.ClusterEvent(e)))
                          if events is not _noop else _noop)

        events(ev.StartingPartitioning())
        coarse_rows = min(s_have, s_coarse)
        sub = (sample if coarse_rows == s_have
               else sample[rng.permutation(s_have)[:coarse_rows]])
        sample_dev = torch.as_tensor(sub, device=dev)
        coarse = kmeans.fit(sample_dev[None], p, g_coarse,
                            handler=cluster_events, impl=self._impl)
        cents = coarse.centroids[0]                        # [P, M]
        events(ev.FinishedPartitioning())

        events(ev.StartingSubvectorDivision())
        pq_rows = min(s_have, s_pq)
        if pq_rows == coarse_rows:
            pq_dev = sample_dev
        else:
            sel = (slice(None) if pq_rows == s_have
                   else rng.permutation(s_have)[:pq_rows])
            pq_dev = torch.as_tensor(sample[sel], device=dev)
        pidx_s = assign_chunked(pq_dev[None], cents[None])[0][0]
        residues_s = pq_dev - cents[pidx_s.long()]
        events(ev.FinishedSubvectorDivision())

        for i in range(d):
            events(ev.StartingQuantization(i))
        rotation = None
        if self._opq_iters:
            from .ops.opq import fit_opq
            opq = fit_opq(residues_s, d, c, g_pq, iters=self._opq_iters)
            rotation, pq = opq.rotation.cpu().numpy(), opq.pq
        else:
            divided = residues_s.reshape(pq_rows, d, m // d) \
                .transpose(0, 1).contiguous()
            pq = kmeans.fit(divided, c, g_pq, handler=cluster_events,
                            impl=self._impl)
            del divided
        for i in range(d):
            events(ev.FinishedQuantization(i))
        # The sample and its device copies go with this frame, before the
        # encode stream.
        return cents, pq.centroids, rotation

    def build_with_events(self, events: EventHandler) -> "Database":
        """Name-parity alias for :meth:`build` (``build.rs:73-78``)."""
        return self.build(events)

    def build(self, events: EventHandler = _noop) -> "Database":
        """The sampled training, then the streamed encode, with the
        in-memory builder's phases and events (``build.rs:78-129``)."""
        from .build import Database, _make_uuids
        from .host import normalize_rows
        from .ops.encode import encode

        n, m = self._n, self._m
        p, d, c = (self._num_partitions, self._num_divisions,
                   self._num_clusters)
        if n < p:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {p}")
        if n < c:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {c}")
        if m % d != 0:
            raise InvalidArgs(f"vector size ({m}) is not divisible by {d}")

        # Row- and byte-capped sample sizes, floored at the cluster counts
        # (a budget below k rows cannot train k centroids).
        byte_rows = max(1, self._sample_bytes // (4 * m))
        s_coarse = min(n, max(self._coarse_cap, p), max(byte_rows, p))
        s_pq = min(n, max(self._pq_cap, c), max(byte_rows, c))

        mesh = self._mesh
        seed = (np.random.SeedSequence().entropy if self._seed is None
                else self._seed)
        if mesh is not None and self._seed is None:   # one seed, rank 0's
            seed = int(broadcast(mesh, torch.tensor(seed % 2 ** 63)))
        rng = np.random.default_rng(seed)
        dev = self._device if mesh is None else mesh.device
        key = int(np.uint32(rng.integers(0, 2 ** 32)))

        events(ev.StartingIdAssignment())
        vector_ids = _make_uuids(n, rng)
        events(ev.FinishedIdAssignment())

        # One sample serves both fits (uniform rows either way), drawn
        # WITHOUT replacement so that it never comes up short of the
        # cluster-count floor.
        s_max = max(s_coarse, s_pq)
        if s_max >= n:
            rows = np.arange(n, dtype=np.int64)
        elif 2 * s_max >= n:
            # Dense sample: a full permutation costs <= 2x the sample.
            rows = np.sort(rng.permutation(n)[:s_max].astype(np.int64))
        else:
            # Sparse sample: draw and dedupe, topping up the shortfall.
            rows = np.unique(rng.integers(0, n, size=s_max, dtype=np.int64))
            for _ in range(16):
                if len(rows) >= s_max:
                    break
                extra = rng.integers(0, n, size=2 * (s_max - len(rows)),
                                     dtype=np.int64)
                rows = np.unique(np.concatenate([rows, extra]))
            else:  # pragma: no cover - probabilistically unreachable
                rows = np.sort(rng.permutation(n)[:s_max].astype(np.int64))
            if len(rows) > s_max:   # trim the overshoot; sorted for IO
                rows = np.sort(rows[rng.permutation(len(rows))[:s_max]])
        if mesh is None or mesh.rank == 0:
            cents, books, rotation = self._train(rows, rng, key, s_coarse,
                                                 s_pq, events, dev)
        else:
            cents = torch.empty((p, m), device=dev)
            books = torch.empty((d, c, m // d), device=dev)
            rotation = np.empty((m, m), np.float32) if self._opq_iters \
                else None
        if mesh is not None:             # exact copies of rank 0's
            cents, books = broadcast(mesh, cents), broadcast(mesh, books)
            if rotation is not None:
                rotation = broadcast(mesh, torch.as_tensor(rotation)) \
                    .numpy()

        chunk = min(self._chunk_rows or max(1, CHUNK_BYTES // (4 * m)), n)
        rot_dev = (None if rotation is None
                   else torch.as_tensor(rotation, device=dev))
        pidx = np.empty(n, np.int32)
        codes = np.empty((n, d), np.uint32)
        # Each rank's block of a chunk: whole ASSIGN_CHUNK units of it.
        ca, cz = (0, chunk) if mesh is None else \
            mesh.block(chunk, ASSIGN_CHUNK)
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            xb = np.asarray(self._source[min(hi, lo + ca):min(hi, lo + cz)],
                            dtype=np.float32)
            if self._metric == "cosine":
                xb = normalize_rows(xb)
            if len(xb) < cz - ca:              # pad rows' codes are dropped
                xb = np.pad(xb, ((0, cz - ca - len(xb)), (0, 0)))
            pi, co = (encode(torch.as_tensor(xb, device=dev), cents, books,
                             rot_dev) if cz > ca else
                      (torch.zeros(0, device=dev), torch.zeros((0, d),
                                                                device=dev)))
            if mesh is not None:
                sizes = block_sizes(mesh, chunk, ASSIGN_CHUNK)
                pi = gather_blocks(mesh, pi.to(torch.int32), sizes)
                co = gather_blocks(mesh, co.to(torch.int32), sizes)
            pidx[lo:hi] = pi[:hi - lo].cpu().numpy()
            codes[lo:hi] = co[:hi - lo].cpu().numpy()

        return Database(
            vector_size=m,
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=cents.cpu().numpy(),
            partition_indices=pidx,
            codebooks=books.cpu().numpy(),
            codes=codes,
            residues=None,
            rotation=rotation,
            metric=self._metric,
            device=str(dev),
        )
