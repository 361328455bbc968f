"""Database serialization.

Artifact layout matches the reference (``src/db/build/proto.rs:25-63``):

* ``partitions/<hash>.binpb``  — per-partition codes + centroid, compressed
* ``partitions/<hash>.binpb``  — partition centroids VectorSet, *uncompressed*
* ``codebooks/<hash>.binpb``   — per-division codebook VectorSet, uncompressed
* ``attributes/<hash>.binpb``  — per-partition attributes log, compressed
* ``<hash>.binpb``             — root Database manifest, compressed

Every file is content-addressed (see :mod:`.io`), so the tree is immutable
and self-verifying; the root manifest names everything else.

A copy of the JAX package's ``serialize.py`` over the port's
:class:`.build.Database` (which has the same host fields), for the reason
given in :mod:`.errors`: the same arrays give the same tree, byte for byte
(``tests/test_torch_stored.py``). The pack pool is sized from the CPUs
this process may run on (:func:`.host.usable_cpus`); the bytes do not
depend on its size. An OPQ rotation is saved under ``rotations/`` as a
VectorSet, named by the root's extension field ``rotation_id``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from .build import Database
from .host import usable_cpus
from .io import FileSystem
from .protos import (
    PAttributesLog,
    PAttributeValue,
    PDatabase,
    PEncodedVectorSet,
    POperationSetAttribute,
    PPartition,
    PUuid,
    PVectorSet,
)
from .protos.wire import encode_uuid_records as wire_encode_uuid_records

PROTOBUF_EXTENSION = "binpb"


def _pack_workers(tasks: int) -> int:
    """Thread count for the per-artifact pack (encode + deflate + SHA +
    write). The native ``fastio`` one-pass pack releases the GIL and the
    payload encodes are numpy-bulk, so artifact packing scales across
    host cores; the reference packs serially (``db/build/proto.rs:25-63``
    walks artifacts one by one), which is the row this beats. Sized from
    the CPUs this process may run on, not from the machine's count."""
    return max(1, min(8, tasks, usable_cpus()))


def save_database(db: Database, fs: FileSystem) -> str:
    """Serializes ``db`` into ``fs``; returns the root manifest hash.

    Mirrors ``serialize_database`` (``db/build/proto.rs:25-63``): partitions
    first, then partition centroids, codebooks, attribute logs, finally the
    root manifest. Independent artifacts are packed on a small thread
    pool (content addressing makes write order irrelevant to the tree,
    and each artifact lands via tempfile + rename): the bytes are
    byte-identical to the serial walk — ``test_golden*`` resave checks
    pin that — only the wall time changes.
    """
    attribute_names = _sorted_attribute_names(db)
    with ThreadPoolExecutor(_pack_workers(db.num_partitions + 4)) as pool:
        partition_ids = _save_partitions(db, fs, pool)
        cents_f = pool.submit(_save_vector_set, db.partition_centroids,
                              fs, "partitions")
        codebook_fs = [
            pool.submit(_save_vector_set, db.codebooks[d], fs, "codebooks")
            for d in range(db.num_divisions)
        ]
        attributes_log_ids = _save_attribute_logs(
            db, partition_ids, attribute_names, fs, pool)
        partition_centroids_id = cents_f.result()
        codebook_ids = [f.result() for f in codebook_fs]
    rotation_id = ""
    if getattr(db, "rotation", None) is not None:
        # OPQ extension artifact; see protos.messages.PDatabase.rotation_id.
        rotation_id = _save_vector_set(db.rotation, fs, "rotations")

    root = PDatabase(
        vector_size=db.vector_size,
        num_partitions=db.num_partitions,
        num_divisions=db.num_divisions,
        num_codes=db.num_clusters,
        partition_ids=partition_ids,
        partition_centroids_id=partition_centroids_id,
        codebook_ids=codebook_ids,
        attributes_log_ids=attributes_log_ids,
        attribute_names=attribute_names,
        rotation_id=rotation_id,
        # "" for L2 keeps the root byte-identical to the reference format;
        # non-L2 writes extension field 21 (see :mod:`.host`).
        metric=("" if getattr(db, "metric", "l2") in ("", "l2")
                else db.metric),
    )
    f = fs.create_hashed_file(compress=True)
    f.write(root.encode())
    return f.persist(PROTOBUF_EXTENSION)


def _partition_payload(db: Database, pi: int,
                       uuid_raw: np.ndarray | None = None,
                       members: np.ndarray | None = None) -> bytes:
    """Encoded ``Partition`` message for partition ``pi``
    (``db/build/proto.rs:66-98``). Members keep their original input
    order — the same order the reference's index-filter extraction
    produces (``db/build.rs:462-472``).

    ``uuid_raw`` (``[N, 16] uint8``, precomputed once per save) enables
    the bulk vector-ids encoding: field 12 is the message's last field,
    so appending the records after the id-less encode is canonical field
    order, byte-identical to the per-message loop."""
    if members is None:
        members = np.nonzero(db.partition_indices == pi)[0]
    head = PPartition(
        vector_size=db.vector_size,
        num_divisions=db.num_divisions,
        centroid=db.partition_centroids[pi],
        encoded_vectors=PEncodedVectorSet(
            vector_size=db.num_divisions,
            data=db.codes[members].reshape(-1),
        ),
    )
    if uuid_raw is not None:
        raw = uuid_raw[members]
        if bool(raw[:, :8].any(1).all()) and bool(raw[:, 8:].any(1).all()):
            return head.encode() + wire_encode_uuid_records(12, raw)
    head.vector_ids = [PUuid.from_uuid(db.vector_ids[i]) for i in members]
    return head.encode()


def _vector_set_payload(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    return PVectorSet(vector_size=arr.shape[-1],
                      data=arr.reshape(-1)).encode()


def _uuid_raw(db: Database) -> np.ndarray:
    """``[N, 16] uint8`` big-endian UUID bytes, one bulk conversion."""
    return np.frombuffer(
        b"".join(u.bytes for u in db.vector_ids), np.uint8).reshape(-1, 16)


def _save_partitions(db: Database, fs: FileSystem,
                     pool: ThreadPoolExecutor | None = None) -> List[str]:
    """One compressed file per partition (``db/build/proto.rs:66-98``)."""
    uuid_raw = _uuid_raw(db)

    def one(pi: int) -> str:
        f = fs.create_hashed_file("partitions", compress=True)
        f.write(_partition_payload(db, pi, uuid_raw))
        return f.persist(PROTOBUF_EXTENSION)

    if pool is None:
        return [one(pi) for pi in range(db.num_partitions)]
    return list(pool.map(one, range(db.num_partitions)))


def _save_vector_set(arr: np.ndarray, fs: FileSystem, subdir: str) -> str:
    """Uncompressed VectorSet file (centroids / codebooks,
    ``db/build/proto.rs:101-146``)."""
    f = fs.create_hashed_file(subdir, compress=False)
    f.write(_vector_set_payload(arr))
    return f.persist(PROTOBUF_EXTENSION)


def _sorted_attribute_names(db: Database) -> List[str]:
    """Attribute names are interned sorted (``db/build/proto.rs:149-158``)."""
    names = set()
    for attrs in db.attribute_table.values():
        names.update(attrs.keys())
    return sorted(names)


def _attributed_by_partition(db: Database) -> dict:
    """``{pi: [(vi, vid, attrs), ...]}`` for vectors that HAVE attributes,
    member-order (ascending ``vi``) within each partition.

    Built once per save: the per-partition log writer previously walked
    every corpus vector per partition (N dict probes + N uuid hashes —
    ~0.2 s of the headline-shape save for 1 000 attributed vectors out of
    100 000); attributes are sparse, so index the attributed side
    instead. Entry order — and therefore bytes — is unchanged:
    ascending member index within each partition, all of a vector's
    attributes in insertion order (``db/build/proto.rs:163-205``).
    """
    if not db.attribute_table:
        return {}
    vid_to_vi = {vid: i for i, vid in enumerate(db.vector_ids)}
    by_part: dict = {}
    for vid, attrs in db.attribute_table.items():
        if not attrs:
            continue
        vi = vid_to_vi.get(vid)
        if vi is None:
            # A stale table entry whose vector is gone (e.g. a future
            # update path that removes vectors without pruning the
            # table): the old per-partition walk silently skipped it, so
            # skipping preserves behavior — a KeyError mid-save would
            # leave a partial tree.
            continue
        by_part.setdefault(int(db.partition_indices[vi]), []).append(
            (vi, vid, attrs))
    for members in by_part.values():
        members.sort(key=lambda t: t[0])
    return by_part


def _attr_log_payload(db: Database, pi: int, partition_id: str,
                      attribute_names: List[str],
                      name_index: dict | None = None,
                      by_part: dict | None = None) -> bytes:
    """Encoded set-op log for partition ``pi``
    (``db/build/proto.rs:163-205``). Callers looping over partitions pass
    a precomputed ``name_index`` / ``by_part`` so they aren't rebuilt P
    times."""
    if name_index is None:
        name_index = {n: i for i, n in enumerate(attribute_names)}
    if by_part is None:
        by_part = _attributed_by_partition(db)
    log = PAttributesLog(partition_id=partition_id)
    for _vi, vid, attrs in by_part.get(pi, ()):
        for name, value in attrs.items():
            log.entries.append(POperationSetAttribute(
                vector_id=PUuid.from_uuid(vid),
                name_index=name_index[name],
                value=PAttributeValue(value=value),
            ))
    return log.encode()


def _save_attribute_logs(db: Database, partition_ids: List[str],
                         attribute_names: List[str],
                         fs: FileSystem,
                         pool: ThreadPoolExecutor | None = None,
                         ) -> List[str]:
    """One compressed set-op log per partition
    (``db/build/proto.rs:163-205``)."""
    name_index = {n: i for i, n in enumerate(attribute_names)}
    by_part = _attributed_by_partition(db)

    def one(pi: int) -> str:
        f = fs.create_hashed_file("attributes", compress=True)
        f.write(_attr_log_payload(db, pi, partition_ids[pi],
                                  attribute_names, name_index, by_part))
        return f.persist(PROTOBUF_EXTENSION)

    if pool is None:
        return [one(pi) for pi in range(db.num_partitions)]
    return list(pool.map(one, range(db.num_partitions)))
