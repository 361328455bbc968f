"""Flat (exact-search) database — reference roadmap item, implemented.

The reference lists "Flat database" as unreleased future work
(``README.md:74``). This module ships it on the device: raw vectors stored
in content-addressed chunks (same hashing/compression/attribute machinery
as the IVF-PQ format, :mod:`.serialize`), exact k-NN served by the chunked
device scan in :mod:`.ops.exact`, and — because chunks are independent
immutable artifacts — **appending vectors is an O(new-data) update**: write
the new chunks and a new root manifest, everything else is reused. That
makes this the first concrete cut of the reference's other roadmap item,
"Update database" (``README.md:73``).

A port of the JAX package's ``flat.py`` (for the reason given in
:mod:`.errors`), held against it by ``tests/test_torch_flat.py``: the same
ids for the same seed, the same results within the JAX tolerance, the same
tree byte for byte, the same messages. What differs: the corpus lives on an
explicit device (``device=``, ``"cuda"`` by default; a CUDA device that is
missing raises, nothing falls back to the CPU), and ``preload(mesh=)``
takes a :class:`.parallel.mesh.CorpusMesh`: the corpus rows split across
the ranks and every query is a collective call
(:mod:`.parallel.exact`).
"""

from __future__ import annotations

import asyncio
import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .attributes import AttributeTable, AttributeValue, check_attribute_value
from .build import _make_uuids
from .errors import InvalidArgs, InvalidData
from .filters import ColumnCache, evaluate_mask
from .host import VALID_METRICS, as_vector_set, check_metric, normalize_rows
from .io import FileSystem
from .ops.exact import exact_keys, exact_topk
from .protos import (
    PAttributesLog,
    PAttributeValue,
    PFlatChunk,
    PFlatDatabase,
    POperationSetAttribute,
    PUuid,
    PVectorSet,
)
from .serialize import PROTOBUF_EXTENSION
from .stored import replay_attributes_log
from .utils.profiling import annotate, annotated

#: Vectors per stored chunk (f32 rows; 4096×1536 ≈ 25 MB uncompressed).
CHUNK_ROWS = 4096


@dataclass
class FlatQueryResult:
    """One exact k-NN result."""
    vector_id: _uuid.UUID
    vector_index: int           # global corpus row
    squared_distance: float

    _get_attr: Optional[callable] = field(default=None, repr=False)

    def get_attribute(self, key: str) -> Optional[AttributeValue]:
        if self._get_attr is None:
            raise InvalidArgs("result is not attached to a database")
        return self._get_attr(self.vector_id, key)


def _kernel_metric(metric: str) -> str:
    """The scan's key: cosine ranks by the L2 key over unit vectors."""
    return "dot" if metric == "dot" else "l2"


def _place(x: np.ndarray, device: str, mesh) -> torch.Tensor:
    """The corpus on ``device``, or this rank's block of it on a mesh."""
    if mesh is None:
        return torch.as_tensor(x, device=device)
    from .parallel.exact import shard_flat
    return shard_flat(mesh, x)[0]


def _exact_query(vs: np.ndarray, dev: torch.Tensor,
                 mask: Optional[np.ndarray], *, k: int, metric: str,
                 mesh=None, n: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The exact top-k on ``dev``'s device, shared by every flat tier:
    host ``(dists [B, k], rows [B, k])``. On a ``mesh`` ``dev`` is this
    rank's block of the ``n`` rows, and the call is collective."""
    with annotate("fdb.to_device"):
        q = torch.as_tensor(vs, device=dev.device)
        if mask is None:
            row_mask = None
        elif mesh is not None:
            from .parallel.mesh import shard_mask
            row_mask = shard_mask(mesh, mask)
        else:
            row_mask = torch.as_tensor(mask, device=dev.device)
    with annotate("fdb.exact"):
        if mesh is not None:
            from .parallel.exact import exact_sharded
            dists, rows = exact_sharded(q, dev, row_mask, mesh=mesh, k=k,
                                        n=n, metric=_kernel_metric(metric))
        else:
            dists, rows = exact_topk(q, dev, row_mask, k=k,
                                     metric=_kernel_metric(metric))
    with annotate("fdb.to_host"):       # where the host waits for the card
        return dists.cpu().numpy(), rows.cpu().numpy()


def _exact_range_keys(v: np.ndarray, dev: torch.Tensor, metric: str,
                      mesh=None, n: int = 0) -> np.ndarray:
    """Exact ranking keys of one query ``[1, M]`` against the corpus on
    the device (on a ``mesh``, over every rank's block of the ``n``
    rows), moved to the host for the threshold: ``[N]``."""
    q = torch.as_tensor(v, device=dev.device)
    if mesh is not None:
        from .parallel.exact import exact_keys_sharded
        keys = exact_keys_sharded(q, dev, mesh=mesh, n=n,
                                  metric=_kernel_metric(metric))
    else:
        keys = exact_keys(q, dev, _kernel_metric(metric))
    return keys[0].cpu().numpy()


def _range_order(keys: np.ndarray, radius: float,
                 limit: Optional[int]) -> List[int]:
    """Rows whose key is ``<= radius``, ascending by key (stable), capped
    at ``limit``."""
    hit = np.nonzero(keys <= radius)[0]
    order = hit[np.argsort(keys[hit], kind="stable")]
    if limit is not None:
        order = order[:limit]
    return order.tolist()


def _to_results(dists: np.ndarray, rows: np.ndarray, ids, get_attr
                ) -> List[FlatQueryResult]:
    """One query's ranked ``(dists, rows)`` as results, stopping at the
    first ``+inf`` (fewer reachable rows than k)."""
    results = []
    for dist, row in zip(dists, rows):
        if not np.isfinite(dist):
            break
        results.append(FlatQueryResult(
            vector_id=ids[row],
            vector_index=int(row),
            squared_distance=float(dist),
            _get_attr=get_attr,
        ))
    return results


def _prep_query(v, vector_size: int, metric: str) -> np.ndarray:
    """One query as ``[1, M]`` f32, unit-normalized for cosine."""
    v = np.asarray(v, np.float32).reshape(1, -1)
    if v.shape[1] != vector_size:
        raise InvalidArgs(
            f"query vector size {v.shape[1]} != {vector_size}")
    if metric == "cosine":
        v = normalize_rows(v, "query")
    return v


def _check_radius(radius) -> None:
    if not np.isfinite(radius):
        raise InvalidArgs(f"radius must be finite: {radius}")


class FlatDatabase:
    """In-memory exact-search database, served from ``device``."""

    def __init__(self, vectors, vector_ids: Optional[List[_uuid.UUID]] = None,
                 seed: Optional[int] = None, metric: str = "l2",
                 device: str | torch.device = "cuda") -> None:
        self.metric = check_metric(metric)
        self.device = str(torch.device(device))
        self._x = as_vector_set(vectors)
        if self.metric == "cosine":
            self._x = normalize_rows(self._x)
        rng = np.random.default_rng(seed)
        if vector_ids is None:
            vector_ids = _make_uuids(len(self._x), rng)
        if len(vector_ids) != len(self._x):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(self._x)} vectors")
        self.vector_ids = list(vector_ids)
        self.attribute_table: AttributeTable = {}
        self._dev: Optional[torch.Tensor] = None
        self._mesh = None
        self._rng = rng
        self._filter_cache: Optional[ColumnCache] = None

    def preload(self, mesh=None) -> None:
        """Pushes the corpus to this database's device, or, with a
        :class:`.parallel.mesh.CorpusMesh`, this rank's block of its rows
        to the mesh's device: queries then run the sharded exact scan
        (:func:`.parallel.exact.exact_sharded`), each a collective call.
        Queries preload lazily on first use, under the last mesh given.
        A no-op when already resident under the same mesh."""
        if self._dev is not None and mesh is self._mesh:
            return
        self._mesh = mesh
        self._dev = _place(self._x, self.device, mesh)

    # -- accessors -----------------------------------------------------------

    @property
    def vector_size(self) -> int:
        return self._x.shape[1]

    @property
    def num_vectors(self) -> int:
        return self._x.shape[0]

    @property
    def vectors(self) -> np.ndarray:
        return self._x

    # -- updates (roadmap "Update database": append-only) --------------------

    def append(self, vectors, vector_ids: Optional[List[_uuid.UUID]] = None,
               ) -> List[_uuid.UUID]:
        """Appends vectors; returns their IDs. O(new data) when re-saved."""
        new = as_vector_set(vectors, self.vector_size)
        if self.metric == "cosine":
            new = normalize_rows(new)
        if vector_ids is None:
            vector_ids = _make_uuids(len(new), self._rng)
        if len(vector_ids) != len(new):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(new)} vectors")
        self._x = np.concatenate([self._x, new])
        self.vector_ids.extend(vector_ids)
        self._dev = None
        self._invalidate_filters()
        return list(vector_ids)

    def remove(self, vector_ids) -> int:
        """Removes vectors by ID; returns the number removed.

        Unknown IDs raise :class:`InvalidArgs`. Re-saving rewrites only
        the chunks that lost members (content addressing keeps the rest).
        """
        doomed = set(vector_ids)
        if not doomed:
            return 0
        row_of = {vid: i for i, vid in enumerate(self.vector_ids)}
        missing = [vid for vid in doomed if vid not in row_of]
        if missing:
            raise InvalidArgs(f"no such vector ID: {missing[0]}")
        keep = np.ones(self.num_vectors, bool)
        keep[[row_of[vid] for vid in doomed]] = False
        self._x = self._x[keep]
        self.vector_ids = [vid for vid, kp in zip(self.vector_ids, keep)
                           if kp]
        for vid in doomed:
            self.attribute_table.pop(vid, None)
        self._dev = None
        self._invalidate_filters()
        return len(doomed)

    def _invalidate_filters(self) -> None:
        if self._filter_cache is not None:
            self._filter_cache.invalidate()

    def _filter_mask(self, where) -> np.ndarray:
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        return evaluate_mask(where, self.vector_ids, self.attribute_table,
                             self._filter_cache)

    # -- attributes -----------------------------------------------------------

    def set_attribute_at(self, i: int,
                         attribute: Tuple[str, AttributeValue]) -> None:
        if not 0 <= i < self.num_vectors:
            raise InvalidArgs(f"vector index out of bounds: {i}")
        key, value = attribute
        value = check_attribute_value(value)
        vid = self.vector_ids[i]
        self.attribute_table.setdefault(vid, {})[str(key)] = value
        self._invalidate_filters()

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        try:
            attrs = self.attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    # -- queries ---------------------------------------------------------------

    def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        return self.query_batch(np.asarray(v, np.float32)[None], k,
                                where=where)[0]

    @annotated("fdb.query_batch")
    def query_batch(self, vs, k: int,
                    where=None) -> List[List[FlatQueryResult]]:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        vs = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            vs = normalize_rows(vs, "query")
        self.preload(self._mesh)
        mask = None if where is None else self._filter_mask(where)
        dists, rows = _exact_query(vs, self._dev, mask, k=k,
                                   metric=self.metric, mesh=self._mesh,
                                   n=self.num_vectors)
        with annotate("fdb.results"):
            return [_to_results(dists[b], rows[b], self.vector_ids,
                                self._get_attr_default_none)
                    for b in range(len(vs))]

    def query_range(self, v, radius: float, limit: Optional[int] = None,
                    where=None) -> List[FlatQueryResult]:
        """Exact range search (EXTENSION): every vector whose ranking
        key is ``<= radius``, ascending (key semantics per metric as in
        :meth:`.build.Database.query_range`). ``limit`` caps the
        result count."""
        _check_radius(radius)
        v = _prep_query(v, self.vector_size, self.metric)
        self.preload(self._mesh)
        mask = None if where is None else self._filter_mask(where)
        keys = _exact_range_keys(v, self._dev, self.metric, self._mesh,
                                 self.num_vectors)
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        return [
            FlatQueryResult(
                vector_id=self.vector_ids[r],
                vector_index=int(r),
                squared_distance=float(keys[r]),
                _get_attr=self._get_attr_default_none,
            )
            for r in _range_order(keys, radius, limit)
        ]

    def _get_attr_default_none(self, vid, key):
        return self.attribute_table.get(vid, {}).get(key)


def _chunk_uuids(msg: PFlatChunk) -> List[_uuid.UUID]:
    """Chunk ids as ``uuid.UUID``s — straight from the bulk-decoded raw
    bytes when available (skips the intermediate PUuid objects)."""
    if msg.ids_raw is not None:
        return [_uuid.UUID(bytes=r.tobytes()) for r in msg.ids_raw]
    return [u.to_uuid() for u in msg.vector_ids]


def _decode_chunk(payload: bytes, vector_size: int, messages: bool = True
                  ) -> tuple[np.ndarray, List[_uuid.UUID]]:
    """A chunk file's rows and ids, shape-checked. ``messages=False``
    raises the async tier's shorter ``InvalidData`` text (the JAX
    package's two tiers word the mismatch apart)."""
    msg = PFlatChunk.decode(payload)
    if msg.vector_size != vector_size:
        raise InvalidData(
            f"chunk vector_size {msg.vector_size} != {vector_size}"
            if messages else "chunk vector_size mismatch")
    if msg.vectors is None:
        raise InvalidData("missing chunk vectors")
    x = msg.vectors.data.reshape(-1, vector_size)
    if len(x) != msg.ids_count:
        raise InvalidData("chunk id/vector count mismatch")
    return x, _chunk_uuids(msg)


def _concat_chunks(parts, vector_size: int
                   ) -> tuple[np.ndarray, List[_uuid.UUID]]:
    """All chunks host-side: ``([N, M] f32, ids)``. ``np.concatenate``
    always copies, so the result never aliases the per-chunk caches."""
    x = (np.concatenate([p[0] for p in parts]) if parts
         else np.zeros((0, vector_size), np.float32))
    return x, [vid for p in parts for vid in p[1]]


def save_flat_database(db: FlatDatabase, fs: FileSystem) -> str:
    """Serializes into content-addressed chunks; returns the root hash."""
    chunk_ids: List[str] = []
    log_ids: List[str] = []
    names = sorted({k for attrs in db.attribute_table.values()
                    for k in attrs})
    name_index = {n: i for i, n in enumerate(names)}
    uuid_raw = (np.frombuffer(
        b"".join(u.bytes for u in db.vector_ids),
        np.uint8).reshape(-1, 16) if db.num_vectors else None)
    for start in range(0, db.num_vectors, CHUNK_ROWS):
        rows = db.vectors[start:start + CHUNK_ROWS]
        ids = db.vector_ids[start:start + CHUNK_ROWS]
        raw = uuid_raw[start:start + CHUNK_ROWS]
        # Bulk-record encode needs every 64-bit half non-zero (proto3
        # omits zero scalars, changing the record length); fall back to
        # the per-message path for the ~2^-64-probability zero halves.
        if bool(raw[:, :8].any(1).all()) and bool(raw[:, 8:].any(1).all()):
            id_args = {"ids_raw": raw}
        else:
            id_args = {"vector_ids": [PUuid.from_uuid(v) for v in ids]}
        chunk = PFlatChunk(
            vector_size=db.vector_size,
            vectors=PVectorSet(vector_size=db.vector_size,
                               data=rows.reshape(-1)),
            **id_args,
        )
        f = fs.create_hashed_file("chunks", compress=True)
        f.write(chunk.encode())
        chunk_id = f.persist(PROTOBUF_EXTENSION)
        chunk_ids.append(chunk_id)

        log = PAttributesLog(partition_id=chunk_id)
        for vid in ids:
            for name, value in db.attribute_table.get(vid, {}).items():
                log.entries.append(POperationSetAttribute(
                    vector_id=PUuid.from_uuid(vid),
                    name_index=name_index[name],
                    value=PAttributeValue(value=value)))
        f = fs.create_hashed_file("attributes", compress=True)
        f.write(log.encode())
        log_ids.append(f.persist(PROTOBUF_EXTENSION))

    root = PFlatDatabase(
        vector_size=db.vector_size,
        num_vectors=db.num_vectors,
        chunk_ids=chunk_ids,
        attributes_log_ids=log_ids,
        attribute_names=names,
        metric="" if db.metric == "l2" else db.metric,
    )
    f = fs.create_hashed_file(compress=True)
    f.write(root.encode())
    return f.persist(PROTOBUF_EXTENSION)


def load_flat_database(fs: FileSystem, path: str,
                       device: str | torch.device = "cuda"
                       ) -> "StoredFlatDatabase":
    """Loads the root manifest only; chunks load at the first query (or
    :meth:`StoredFlatDatabase.preload`) onto ``device``, ``"cuda"`` by
    default."""
    f = fs.open_hashed_file(path, compressed=True)
    payload = f.read()
    f.verify()
    root = PFlatDatabase.decode(payload)
    _validate_flat_root(root)
    return StoredFlatDatabase(fs=fs, root=root, device=device)


def _validate_flat_root(root: PFlatDatabase) -> None:
    if root.vector_size == 0:
        raise InvalidData("vector_size is zero")
    if len(root.chunk_ids) != len(root.attributes_log_ids):
        raise InvalidData("chunk/attributes-log count mismatch")
    if getattr(root, "metric", "") not in ("",) + VALID_METRICS:
        raise InvalidData(f"unknown metric: {root.metric!r}")


class _Members:
    """Adapter: :func:`.stored.replay_attributes_log` reads a partition's
    ``.vector_ids``; a chunk's ids stand in for them."""

    def __init__(self, vector_ids: List[_uuid.UUID]) -> None:
        self.vector_ids = vector_ids


@dataclass
class StoredFlatDatabase:
    """Lazily-loaded stored flat database, served from ``device``."""
    fs: FileSystem
    root: PFlatDatabase
    device: str = "cuda"

    _chunks: List[Optional[tuple]] = field(default=None, repr=False)
    _attr_loaded: List[bool] = field(default=None, repr=False)
    _attribute_table: AttributeTable = field(default_factory=dict, repr=False)
    _dev: Optional[tuple] = field(default=None, repr=False)
    _filter_cache: Optional[ColumnCache] = field(default=None, repr=False)
    _mesh: Optional[object] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.device = str(torch.device(self.device))
        self._chunks = [None] * len(self.root.chunk_ids)
        self._attr_loaded = [False] * len(self.root.chunk_ids)

    @property
    def vector_size(self) -> int:
        return self.root.vector_size

    @property
    def num_vectors(self) -> int:
        return self.root.num_vectors

    @property
    def attribute_names(self) -> List[str]:
        return self.root.attribute_names

    @property
    def metric(self) -> str:
        """Query metric (root extension field 21; "" = "l2")."""
        return getattr(self.root, "metric", "") or "l2"

    def _load_chunk(self, i: int) -> tuple:
        if self._chunks[i] is None:
            f = self.fs.open_hashed_file(
                f"chunks/{self.root.chunk_ids[i]}.{PROTOBUF_EXTENSION}",
                compressed=True)
            payload = f.read()
            f.verify()
            self._chunks[i] = _decode_chunk(payload, self.vector_size)
        return self._chunks[i]

    def _load_all_host(self):
        """All chunks concatenated host-side: ``([N, M] f32, ids)``."""
        return _concat_chunks([self._load_chunk(i)
                               for i in range(len(self.root.chunk_ids))],
                              self.vector_size)

    def _load_all(self):
        if self._dev is None:
            x, ids = self._load_all_host()
            self._dev = (_place(x, self.device, self._mesh), ids)
        return self._dev

    def preload(self, mesh=None) -> None:
        """Loads every chunk and pushes the corpus to this database's
        device, or this rank's block of it to a
        :class:`.parallel.mesh.CorpusMesh`'s (the flat analogue of
        :meth:`.stored.StoredDatabase.preload`; queries are then
        collective calls). A no-op when already resident under the same
        mesh."""
        if self._dev is not None and mesh is self._mesh:
            return
        self._mesh = mesh
        self._dev = None
        self._load_all()

    def _mask(self, where, ids) -> Optional[np.ndarray]:
        if where is None:
            return None
        self._ensure_attrs_loaded()
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        return evaluate_mask(where, ids, self._attribute_table,
                             self._filter_cache)

    def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        return self.query_batch(np.asarray(v, np.float32)[None], k,
                                where=where)[0]

    @annotated("fdb.query_batch")
    def query_batch(self, vs, k: int,
                    where=None) -> List[List[FlatQueryResult]]:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        vs = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            vs = normalize_rows(vs, "query")
        xd, ids = self._load_all()
        mask = self._mask(where, ids)
        dists, rows = _exact_query(vs, xd, mask, k=k, metric=self.metric,
                                   mesh=self._mesh, n=self.num_vectors)
        with annotate("fdb.results"):
            return [_to_results(dists[b], rows[b], ids, self.get_attribute)
                    for b in range(len(vs))]

    def query_range(self, v, radius: float, limit: Optional[int] = None,
                    where=None) -> List[FlatQueryResult]:
        """Exact range search over the stored chunks (EXTENSION; key
        semantics per metric as in :meth:`FlatDatabase.query_range`)."""
        _check_radius(radius)
        v = _prep_query(v, self.vector_size, self.metric)
        xd, ids = self._load_all()
        mask = self._mask(where, ids)
        keys = _exact_range_keys(v, xd, self.metric, self._mesh,
                                 self.num_vectors)
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        return [
            FlatQueryResult(
                vector_id=ids[r],
                vector_index=int(r),
                squared_distance=float(keys[r]),
                _get_attr=self.get_attribute,
            )
            for r in _range_order(keys, radius, limit)
        ]

    def _ensure_attrs_loaded(self) -> None:
        for i in range(len(self.root.chunk_ids)):
            if self._attr_loaded[i]:
                continue
            chunk = self._load_chunk(i)
            f = self.fs.open_hashed_file(
                f"attributes/{self.root.attributes_log_ids[i]}"
                f".{PROTOBUF_EXTENSION}",
                compressed=True)
            payload = f.read()
            f.verify()
            replay_attributes_log(
                payload, self.root.chunk_ids[i], self.root.attribute_names,
                _Members(chunk[1]), self._attribute_table, i)
            self._attr_loaded[i] = True

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        self._ensure_attrs_loaded()
        try:
            attrs = self._attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    def to_database(self) -> FlatDatabase:
        """Materializes the stored chunks into an in-memory
        :class:`FlatDatabase` on this database's device — the flat tier's
        update story (mirror of :meth:`.stored.StoredDatabase.to_database`):
        load → mutate (:meth:`FlatDatabase.append` /
        :meth:`FlatDatabase.remove`) → ``save_flat_database`` back into the
        same store. Rows keep chunk order, so an append re-serializes the
        existing full chunks to byte-identical artifacts and the store
        skips their files."""
        x, ids = self._load_all_host()
        self._ensure_attrs_loaded()
        # Stored cosine rows are ALREADY unit vectors; constructing with
        # metric="cosine" would re-normalize (÷ ~0.99999994 in f32) and
        # flip low mantissa bits — breaking the byte-identical re-save
        # contract above. Build as-is, then tag the metric.
        db = FlatDatabase(x, ids, device=self.device)
        db.metric = self.metric
        db.attribute_table = {
            vid: dict(attrs)
            for vid, attrs in self._attribute_table.items()
        }
        return db


async def load_flat_database_async(fs, path: str,
                                   device: str | torch.device = "cuda"
                                   ) -> "AsyncStoredFlatDatabase":
    """Async flat loader (extension parity with :mod:`.asyncdb`); the
    corpus goes to ``device`` at the first query."""
    f = await fs.open_hashed_file(path, compressed=True)
    payload = await f.read()
    f.verify()
    root = PFlatDatabase.decode(payload)
    _validate_flat_root(root)
    return AsyncStoredFlatDatabase(fs=fs, root=root, device=device)


@dataclass
class AsyncStoredFlatDatabase:
    """Asyncio flat database: chunks load concurrently, queries run the
    same exact device scan. Attributes/filters mirror the sync tier:
    ``where=`` on :meth:`query` / :meth:`query_range`, awaitable
    :meth:`get_attribute` (logs load concurrently, once)."""
    fs: object
    root: PFlatDatabase
    device: str = "cuda"

    _load_task: Optional[asyncio.Task] = field(default=None, repr=False)
    _attrs_task: Optional[asyncio.Task] = field(default=None, repr=False)
    _chunk_sizes: Optional[List[int]] = field(default=None, repr=False)
    _attribute_table: AttributeTable = field(default_factory=dict,
                                             repr=False)

    def __post_init__(self) -> None:
        self.device = str(torch.device(self.device))

    @property
    def metric(self) -> str:
        return getattr(self.root, "metric", "") or "l2"

    async def _open(self, path: str) -> bytes:
        f = await self.fs.open_hashed_file(path, compressed=True)
        payload = await f.read()
        f.verify()
        return payload

    async def _load_all(self):
        if self._load_task is None:
            async def one(cid: str):
                payload = await self._open(
                    f"chunks/{cid}.{PROTOBUF_EXTENSION}")
                return _decode_chunk(payload, self.root.vector_size,
                                     messages=False)

            async def load():
                parts = await asyncio.gather(
                    *(one(cid) for cid in self.root.chunk_ids))
                x, ids = _concat_chunks(parts, self.root.vector_size)
                # Per-chunk id counts for attribute-log replay: the wire
                # format does not pin a chunk size, so slices must come
                # from the ACTUAL chunks, never a CHUNK_ROWS constant.
                self._chunk_sizes = [len(p[0]) for p in parts]
                return torch.as_tensor(x, device=self.device), ids

            self._load_task = asyncio.create_task(load())
        return await self._load_task

    async def _ensure_attrs(self) -> None:
        """Loads + replays ALL attribute logs, concurrently, once."""
        if self._attrs_task is None:
            async def load():
                _, all_ids = await self._load_all()
                payloads = await asyncio.gather(*(
                    self._open(f"attributes/{aid}.{PROTOBUF_EXTENSION}")
                    for aid in self.root.attributes_log_ids))
                pos = 0
                for i, payload in enumerate(payloads):
                    # Chunk i's id slice, from the loaded chunks' actual
                    # sizes (any writer's chunking is valid wire format).
                    lo, pos = pos, pos + self._chunk_sizes[i]
                    replay_attributes_log(
                        payload, self.root.chunk_ids[i],
                        self.root.attribute_names,
                        _Members(all_ids[lo:pos]),
                        self._attribute_table, i)

            self._attrs_task = asyncio.create_task(load())
        await self._attrs_task

    async def get_attribute(self, vector_id: _uuid.UUID,
                            key: str) -> Optional[AttributeValue]:
        await self._ensure_attrs()
        try:
            attrs = self._attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    async def _query_mask(self, where, ids) -> Optional[np.ndarray]:
        if where is None:
            return None
        await self._ensure_attrs()
        return evaluate_mask(where, ids, self._attribute_table,
                             ColumnCache())

    async def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        v = _prep_query(v, self.root.vector_size, self.metric)
        xd, ids = await self._load_all()
        mask = await self._query_mask(where, ids)
        dists, rows = _exact_query(v, xd, mask, k=k, metric=self.metric)
        return _to_results(dists[0], rows[0], ids, None)

    async def query_range(self, v, radius: float,
                          limit: Optional[int] = None,
                          where=None) -> List[FlatQueryResult]:
        """Exact range search (EXTENSION; key semantics per metric as in
        :meth:`FlatDatabase.query_range`)."""
        _check_radius(radius)
        v = _prep_query(v, self.root.vector_size, self.metric)
        xd, ids = await self._load_all()
        mask = await self._query_mask(where, ids)
        keys = _exact_range_keys(v, xd, self.metric)
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        return [
            FlatQueryResult(vector_id=ids[r], vector_index=int(r),
                            squared_distance=float(keys[r]))
            for r in _range_order(keys, radius, limit)
        ]
