"""Async (concurrent) database save — BEYOND the reference.

The reference's async layer is read-only (its "Save database
asynchronously" box is unchecked, ``README.md:49-52``; ``asyncdb/io.rs``
has no write path). This module completes that roadmap item the way the
read path already works here: artifact encode+deflate+hash+PUT runs
off-loop (the native one-pass packer releases the GIL), and independent
artifacts fly CONCURRENTLY — on an object store, save latency drops from
``Σ PUT`` to roughly ``max PUT`` per dependency phase.

Dependency phases (the root manifest names everything, and each
attributes log names its partition file, ``db/build/proto.rs:163-205``):

1. partitions ∥ partition-centroids ∥ codebooks ∥ rotation — all at once,
2. per-partition attribute logs — all at once (need partition ids),
3. root manifest.

The resulting tree is byte-identical to :func:`..serialize.save_database`
(same payload builders, same content addressing) — only the write
ordering differs, which content addressing makes unobservable.

A copy of the JAX package's ``asyncdb/save.py`` over the port's
:class:`..build.Database` and its :mod:`..serialize` payload builders (for
the reason given in :mod:`..errors`): the same database gives the JAX
package's tree, byte for byte (``tests/test_torch_asyncdb.py``).
"""

from __future__ import annotations

import asyncio

from ..build import Database
from ..io import FileSystem
from ..protos import PDatabase
from ..serialize import (
    PROTOBUF_EXTENSION,
    _attr_log_payload,
    _attributed_by_partition,
    _partition_payload,
    _sorted_attribute_names,
    _uuid_raw,
    _vector_set_payload,
)


async def save_database(db: Database, fs: FileSystem, *,
                        max_concurrency: int = 16) -> str:
    """Saves ``db`` into ``fs`` with concurrent artifact writes.

    ``fs`` is a SYNC :class:`..io.FileSystem` (local or
    :class:`..objectstore.FsspecFileSystem` — e.g. S3); each artifact's
    encode+pack+PUT runs in a worker thread, at most ``max_concurrency``
    in flight. Returns the root manifest hash, exactly as the sync saver.
    """
    if max_concurrency < 1:
        raise ValueError(f"max_concurrency must be >= 1: {max_concurrency}")
    sem = asyncio.Semaphore(max_concurrency)

    async def put(subdir: str, payload_fn, compress: bool) -> str:
        async with sem:
            def work() -> str:
                f = fs.create_hashed_file(subdir, compress=compress)
                f.write(payload_fn())
                return f.persist(PROTOBUF_EXTENSION)

            return await asyncio.to_thread(work)

    # Phase 1: everything that doesn't reference another artifact. Each
    # put is wrapped in a Task so ALL of them are in flight at once — a
    # bare coroutine would only start at its own await, serializing the
    # centroid/codebook/rotation PUTs behind the partition gather.
    uuid_raw = _uuid_raw(db)
    part_tasks = [
        asyncio.create_task(
            put("partitions",
                lambda pi=pi: _partition_payload(db, pi, uuid_raw), True))
        for pi in range(db.num_partitions)
    ]
    cent_task = asyncio.create_task(
        put("partitions",
            lambda: _vector_set_payload(db.partition_centroids), False))
    cb_tasks = [
        asyncio.create_task(
            put("codebooks",
                lambda d=d: _vector_set_payload(db.codebooks[d]), False))
        for d in range(db.num_divisions)
    ]
    rot_task = None
    if getattr(db, "rotation", None) is not None:
        rot_task = asyncio.create_task(
            put("rotations",
                lambda: _vector_set_payload(db.rotation), False))

    try:
        partition_ids = list(await asyncio.gather(*part_tasks))
        partition_centroids_id = await cent_task
        codebook_ids = list(await asyncio.gather(*cb_tasks))
        rotation_id = await rot_task if rot_task is not None else ""
    except BaseException:
        pending = [t for t in (*part_tasks, cent_task, *cb_tasks, rot_task)
                   if t is not None]
        for t in pending:
            t.cancel()
        # Drain: retrieve sibling failures (else "exception was never
        # retrieved" noise at GC) and wait out in-flight thread writes so
        # nothing keeps mutating the store after this raise.
        await asyncio.gather(*pending, return_exceptions=True)
        raise

    # Phase 2: attribute logs (each names its partition file).
    attribute_names = _sorted_attribute_names(db)
    name_index = {n: i for i, n in enumerate(attribute_names)}
    by_part = _attributed_by_partition(db)
    attributes_log_ids = list(await asyncio.gather(*[
        put("attributes",
            lambda pi=pi: _attr_log_payload(db, pi, partition_ids[pi],
                                            attribute_names, name_index,
                                            by_part),
            True)
        for pi in range(db.num_partitions)
    ]))

    # Phase 3: root manifest.
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
        metric=("" if getattr(db, "metric", "l2") in ("", "l2")
                else db.metric),
    )
    return await put("", root.encode, True)
