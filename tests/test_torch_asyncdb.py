"""The port's async tier (``flechasdb_tpu_torch/asyncdb/``,
``memfs.AsyncMemoryFileSystem``) and ``utils/nbest.py`` against the JAX
package's.

A small database is built by the JAX package on the CPU, given string and
uint64 attributes and one empty partition, and carried into the port by
``from_jax_arrays(device="cpu")``. The async tier runs the same host code
in both packages, so results must be equal to the bit, with the same
events; they must also equal the port's own sync cold tier to the bit. The
async save must write the JAX package's tree (and the port's sync save's),
byte for byte. Overlap is held by count, not by a wall clock: a store that
holds every partition open until as many are in flight as the query
probes.
"""

import asyncio
import dataclasses
import shutil
import uuid

import numpy as np
import pytest

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import asyncdb as jasync
from flechasdb_tpu import memfs as jmemfs
from flechasdb_tpu.asyncdb import io as jaio
from flechasdb_tpu.utils import nbest as jnbest
from flechasdb_tpu_torch import asyncdb as pasync
from flechasdb_tpu_torch import memfs as pmemfs
from flechasdb_tpu_torch import stored as pstored
from flechasdb_tpu_torch.asyncdb import io as paio
from flechasdb_tpu_torch.utils import NBestByKey, n_best_by_key

N, M, P, D, C = 700, 16, 6, 4, 16
K, NPROBE = 5, 3
METRICS = ["l2", "dot", "cosine"]


def _jax_db(metric: str, seed: int = 3):
    """The JAX package's database: attributes on every third row (a string
    on some, a uint64 on all of them) and partition 2 emptied."""
    x = np.random.default_rng(seed).standard_normal((N, M)).astype(
        np.float32)
    db = (fdb.DatabaseBuilder(x).with_partitions(P).with_divisions(D)
          .with_clusters(C).with_seed(seed).with_metric(metric).build())
    for i in range(0, N, 3):
        db.set_attribute_at(i, ("tenant", i % 4))
        if i % 2 == 0:
            db.set_attribute_at(i, ("lang", ["en", "ja"][i % 4 // 2]))
    gone = [db.vector_ids[i] for i in np.flatnonzero(
        np.asarray(db.partition_indices) == 2)]
    db.remove_vectors(gone)
    return x, db


@pytest.fixture(scope="module", params=METRICS)
def tree(request, tmp_path_factory):
    """Both packages' databases and the JAX package's tree."""
    x, jdb = _jax_db(request.param)
    pdb = ft.from_jax_arrays(jdb, device="cpu")
    base = tmp_path_factory.mktemp(f"async-{request.param}")
    root = fdb.save_database(jdb, fdb.LocalFileSystem(base))
    return request.param, x, jdb, pdb, base, root


def _queries(x, n=5, seed=8):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    return (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)


def _fields(results):
    return [(r.vector_id, r.partition_index, r.vector_index,
             r.squared_distance) for r in results]


def _event(e):
    return type(e).__name__, dataclasses.asdict(e)


async def _run(pkg, fs, root, work):
    """Loads ``root`` through ``pkg``'s async tier and awaits ``work(db)``."""
    adb = await pkg.load_database(fs, f"{root}.binpb")
    return await work(adb)


def _both(base, root, work_mine, work_theirs):
    mine = asyncio.run(_run(pasync, pasync.AsyncLocalFileSystem(base), root,
                            work_mine))
    theirs = asyncio.run(_run(jasync, jasync.AsyncLocalFileSystem(base),
                              root, work_theirs))
    return mine, theirs


# -- queries against the JAX async tier ----------------------------------------

def test_async_queries_and_events_match_jax_to_the_bit(tree):
    metric, x, _, _, base, root = tree
    q = _queries(x)

    async def go(adb):
        out = []
        for v in q:
            log = []
            res = await adb.query_with_events(v, K, NPROBE, log.append)
            out.append((_fields(res), [_event(e) for e in log]))
        out.append((_fields(await adb.query(q[0], K, P)), []))
        return out, sorted(adb._partition_tasks)

    mine, theirs = _both(base, root, go, go)
    assert mine == theirs
    # the first query loads cold: its events announce every load
    names = [n for n, _ in mine[0][0][1]]
    assert names[:2] == ["StartingCodebookLoad",
                         "StartingPartitionCentroidsLoad"]
    assert "StartingPartitionLoad" in names
    assert "StartingCodebookLoad" not in [n for n, _ in mine[0][1][1]]


def test_async_filter_range_and_attributes_match_jax(tree):
    metric, x, jdb, _, base, root = tree
    q = _queries(x)
    probe = jdb.query_batch(q, 12, NPROBE)
    radii = [(rs[9].squared_distance + rs[10].squared_distance) / 2
             for rs in probe]
    tagged, attrs = next((vid, a) for vid, a in jdb.attribute_table.items()
                         if "lang" in a)
    bare = next(vid for vid in jdb.vector_ids
                if vid not in jdb.attribute_table)

    def work(pkg):
        async def go(adb):
            out = []
            for v, radius in zip(q, radii):
                res = await adb.query(v, K, NPROBE,
                                      where=pkg.Eq("lang", "en"))
                out.append(_fields(res))
                out.append(await asyncio.gather(
                    *(r.get_attribute("tenant") for r in res)))
                out.append(_fields(await adb.query_range(v, radius,
                                                         NPROBE)))
                out.append(_fields(await adb.query_range(
                    v, radius, NPROBE, limit=3,
                    where=pkg.Range("tenant", 1, 2))))
            out.append(await adb.get_attribute(tagged, "lang"))
            out.append(await adb.get_attribute(bare, "lang"))
            return out
        return go

    mine, theirs = _both(base, root, work(ft), work(fdb))
    assert mine == theirs
    assert any(mine[0]) and mine[-2] == attrs["lang"] and mine[-1] is None


def test_async_errors_match_jax(tree, tmp_path):
    metric, x, jdb, _, base, root = tree

    def attempt(pkg, call):
        async def go(adb):
            try:
                await call(adb)
            except pkg.FlechasError as e:
                return type(e).__name__, str(e)
            return None
        return go

    calls = [
        lambda adb: adb.query(x[0], 0, 1),
        lambda adb: adb.query(x[0], 3, 0),
        lambda adb: adb.query(x[0], 3, P + 1),
        lambda adb: adb.query(x[0, :5], 3, 1),
        lambda adb: adb.query_range(x[0], float("nan"), 1),
        lambda adb: adb.get_attribute(uuid.UUID(int=9), "tenant"),
        lambda adb: adb.get_partition(P),
    ]
    for call in calls:
        mine, theirs = _both(base, root, attempt(ft, call),
                             attempt(fdb, call))
        assert mine == theirs and mine is not None
    with pytest.raises(ft.IOError_):
        asyncio.run(pasync.load_database(
            pasync.AsyncLocalFileSystem(tmp_path), "missing.binpb"))


def test_async_verifies_what_the_sync_tier_skips(tree, tmp_path):
    """A changed byte in the partition centroids: the sync tier's quirk
    reads it unverified, the async tier raises (``asyncdb/stored.rs:284``)
    in both packages."""
    metric, x, _, _, base, root = tree
    dst = tmp_path / "copy"
    shutil.copytree(base, dst)
    sync = ft.load_database(ft.LocalFileSystem(dst), f"{root}.binpb",
                            device="cpu")
    path = dst / "partitions" / f"{sync.root.partition_centroids_id}.binpb"
    data = bytearray(path.read_bytes())
    data[-1] ^= 0x01
    path.write_bytes(bytes(data))
    assert len(sync.query(x[0], 3, 2)) == 3
    for pkg, err in ((pasync, ft.VerificationFailure),
                     (jasync, fdb.VerificationFailure)):
        async def go(adb):
            await adb.query(x[0], 3, 2)
        with pytest.raises(err):
            asyncio.run(_run(pkg, pkg.AsyncLocalFileSystem(dst), root, go))


# -- against the port's own sync cold tier --------------------------------------

def test_async_equals_the_sync_cold_tier_to_the_bit(tree):
    metric, x, _, _, base, root = tree
    q = _queries(x, n=6)
    sync = ft.load_database(ft.LocalFileSystem(base), f"{root}.binpb",
                            device="cpu")
    radius = float(np.median([r.squared_distance
                              for r in sync.query(q[0], 10, NPROBE)]))
    radius = float(np.nextafter(radius, np.inf))
    want = [(_fields(sync.query(v, K, NPROBE)),
             _fields(sync.query(v, K, NPROBE, where=ft.Eq("tenant", 1))),
             _fields(sync.query_range(v, radius, NPROBE)))
            for v in q]
    want_events = []
    sync.query_with_events(q[0], K, NPROBE, want_events.append)

    async def go(adb):
        got = []
        for v in q:
            got.append((_fields(await adb.query(v, K, NPROBE)),
                        _fields(await adb.query(v, K, NPROBE,
                                                where=ft.Eq("tenant", 1))),
                        _fields(await adb.query_range(v, radius, NPROBE))))
        log = []
        res = await adb.query_with_events(q[0], K, NPROBE, log.append)
        return got, _fields(res), log

    got, res, log = asyncio.run(_run(pasync,
                                     pasync.AsyncLocalFileSystem(base),
                                     root, go))
    assert got == want
    assert res == want[0][0]
    # warm, both tiers announce the same per-partition steps
    kinds = {"StartingPartitionQuery", "FinishedPartitionQuery",
             "StartingResultSelection", "FinishedResultSelection"}
    assert [_event(e) for e in log if type(e).__name__ in kinds] == \
        [_event(e) for e in want_events if type(e).__name__ in kinds]


def test_memory_store_serves_the_async_tier(tree):
    metric, x, jdb, pdb, _, _ = tree
    mine, theirs = ft.MemoryFileSystem(), jmemfs.MemoryFileSystem()
    root = ft.save_database(pdb, mine)
    assert fdb.save_database(jdb, theirs) == root

    async def go(adb):
        return _fields(await adb.query(x[7], K, NPROBE))

    got = asyncio.run(_run(pasync, pmemfs.AsyncMemoryFileSystem(
        mine.objects), root, go))
    want = asyncio.run(_run(jasync, jmemfs.AsyncMemoryFileSystem(
        theirs.objects), root, go))
    assert got == want


# -- the async save ---------------------------------------------------------------

@pytest.mark.parametrize("concurrency", [1, 16])
def test_async_save_writes_the_jax_tree(tree, concurrency):
    metric, _, jdb, pdb, _, root = tree
    mine, theirs, sync = (ft.MemoryFileSystem(), jmemfs.MemoryFileSystem(),
                          ft.MemoryFileSystem())
    got = asyncio.run(pasync.save_database(pdb, mine,
                                           max_concurrency=concurrency))
    want = asyncio.run(jasync.save_database(jdb, theirs,
                                            max_concurrency=concurrency))
    assert got == want == root == ft.save_database(pdb, sync)
    assert mine.objects == theirs.objects == sync.objects
    assert any(k.startswith("attributes/") for k in mine.objects)
    with pytest.raises(ValueError, match="max_concurrency"):
        asyncio.run(pasync.save_database(pdb, mine, max_concurrency=0))


def test_async_save_cancels_its_writes_on_a_failure(tree):
    _, _, _, pdb, _, _ = tree

    class Failing(ft.MemoryFileSystem):
        def create_hashed_file(self, subdir="", compress=False):
            if subdir == "codebooks":
                raise ft.IOError_("store down")
            return super().create_hashed_file(subdir, compress)

    fs = Failing()
    with pytest.raises(ft.IOError_, match="store down"):
        asyncio.run(pasync.save_database(pdb, fs))
    assert not any(k.endswith(".binpb") and "/" not in k
                   for k in fs.objects)     # no root was written


# -- OPQ: the async tier reads the rotation ---------------------------------------

@pytest.fixture(scope="module")
def opq_tree(tmp_path_factory):
    """``tests/test_opq.py``'s correlated data (fewer rows), an OPQ build by
    the JAX package, and its tree."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((6, 48)).astype(np.float32)
    z = rng.standard_normal((1500, 6)).astype(np.float32)
    x = (z @ w + 0.02 * rng.standard_normal((1500, 48))).astype(np.float32)
    jdb = (fdb.DatabaseBuilder(x).with_partitions(8).with_divisions(8)
           .with_clusters(32).with_seed(7).with_opq(iters=2).build())
    base = tmp_path_factory.mktemp("async-opq")
    root = fdb.save_database(jdb, fdb.LocalFileSystem(base))
    return x, jdb, base, root


def test_async_opq_leg_matches_jax_and_the_sync_tier(opq_tree):
    x, jdb, base, root = opq_tree
    assert jdb.rotation is not None

    async def go(adb):
        return [_fields(await adb.query(x[i], 5, 8)) for i in (10, 20, 30)]

    mine, theirs = _both(base, root, go, go)
    assert mine == theirs
    sync = ft.load_database(ft.LocalFileSystem(base), f"{root}.binpb",
                            device="cpu")
    assert mine == [_fields(sync.query(x[i], 5, 8)) for i in (10, 20, 30)]
    want = jdb.query(x[10], k=5, nprobe=8)
    assert [f[0] for f in mine[0]] == [r.vector_id for r in want]


def test_async_opq_save_and_query_of_a_port_build(opq_tree):
    x = opq_tree[0]
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(8)
          .with_divisions(8).with_clusters(32).with_seed(7).with_opq(2)
          .build())
    fs = ft.MemoryFileSystem()
    root = asyncio.run(pasync.save_database(db, fs))
    assert root == ft.save_database(db, ft.MemoryFileSystem())
    assert any(k.startswith("rotations/") for k in fs.objects)

    async def go(adb):
        return await adb.query(x[10], 5, 8)

    got = asyncio.run(_run(pasync, pmemfs.AsyncMemoryFileSystem(fs.objects),
                           root, go))
    want = db.query(x[10], k=5, nprobe=8)
    assert [r.vector_id for r in got] == [r.vector_id for r in want]
    np.testing.assert_allclose([r.squared_distance for r in got],
                               [r.squared_distance for r in want],
                               rtol=1e-4, atol=1e-5)


# -- overlap, held by count --------------------------------------------------------

class _GatedStore(pmemfs.AsyncMemoryFileSystem):
    """Holds every partition open until ``release`` is set, counting the
    opens in flight and their peak."""

    def __init__(self, objects):
        super().__init__(objects)
        self.release = asyncio.Event()
        self.in_flight = 0
        self.peak = 0

    async def open_hashed_file(self, path, compressed=False):
        if not (path.startswith("partitions/") and compressed):
            return await super().open_hashed_file(path, compressed)
        self.in_flight += 1
        self.peak = max(self.peak, self.in_flight)
        try:
            await self.release.wait()
            return await super().open_hashed_file(path, compressed)
        finally:
            self.in_flight -= 1


class _CountingStore(ft.MemoryFileSystem):
    """The sync tier's store: counts partition opens in flight."""

    def __init__(self, objects):
        super().__init__(objects)
        self.in_flight = 0
        self.peak = 0

    def open_hashed_file(self, path, compressed=False):
        if not (path.startswith("partitions/") and compressed):
            return super().open_hashed_file(path, compressed)
        self.in_flight += 1
        self.peak = max(self.peak, self.in_flight)
        try:
            return super().open_hashed_file(path, compressed)
        finally:
            self.in_flight -= 1


def test_cold_async_query_overlaps_every_probed_partition(monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(12)
          .with_divisions(4).with_clusters(8).with_seed(3).build())
    objects = ft.MemoryFileSystem().objects
    root = ft.save_database(db, ft.MemoryFileSystem(objects))
    nprobe = 10

    async def go():
        fs = _GatedStore(objects)
        adb = await pasync.load_database(fs, f"{root}.binpb")
        query = asyncio.create_task(adb.query(x[3], 5, nprobe))
        for _ in range(1000):      # until every probed partition is open
            if fs.in_flight >= nprobe or query.done():
                break
            await asyncio.sleep(0)
        fs.release.set()
        return await asyncio.wait_for(query, 30), fs.peak

    res, peak = asyncio.run(go())
    assert peak == nprobe
    # the sync tier on its serial route (one CPU) opens one at a time
    monkeypatch.setattr(pstored, "_query_io_threads", lambda: False)
    fs = _CountingStore(objects)
    sync = ft.load_database(fs, f"{root}.binpb", device="cpu")
    want = sync.query(x[3], 5, nprobe)
    assert fs.peak == 1
    assert _fields(res) == _fields(want)


# -- the async readers and the memory store ------------------------------------

def test_async_readers_match_jax_and_catch_corruption(tmp_path):
    w = ft.LocalFileSystem(tmp_path).create_hashed_file(compress=True)
    w.write(b"payload " * 4096)
    name = f"{w.persist()}.binpb"

    async def read(pkg, **kw):
        fs = pkg.AsyncLocalFileSystem(tmp_path, **kw)
        f = await fs.open_hashed_file(name, compressed=True)
        payload = await f.read()
        f.verify()
        return type(f).__name__, payload

    for kw in ({}, {"streaming_threshold": 0}):
        mine, theirs = asyncio.run(read(paio, **kw)), asyncio.run(
            read(jaio, **kw))
        assert mine == theirs and mine[1] == b"payload " * 4096
    assert mine[0] == "AsyncStreamingHashedFileReader"

    async def early_verify():
        f = await paio.AsyncLocalFileSystem(
            tmp_path, streaming_threshold=0).open_hashed_file(name, True)
        f.verify()

    with pytest.raises(ft.IOError_, match="before read"):
        asyncio.run(early_verify())
    raw = bytearray((tmp_path / name).read_bytes())
    raw[1] = 0xDA            # zlib level hint: still inflates, hash differs
    (tmp_path / name).write_bytes(bytes(raw))
    for kw in ({}, {"streaming_threshold": 0}):
        with pytest.raises(ft.VerificationFailure):
            asyncio.run(read(paio, **kw))
    with pytest.raises(ft.IOError_):
        asyncio.run(paio.AsyncLocalFileSystem(tmp_path).open_hashed_file(
            "missing.binpb"))


def test_async_memory_store_matches_jax():
    w = ft.MemoryFileSystem()
    f = w.create_hashed_file("sub", compress=True)
    f.write(b"abc" * 100)
    key = f"sub/{f.persist()}.binpb"

    async def read(mod, objects, path):
        r = await mod.AsyncMemoryFileSystem(objects).open_hashed_file(
            path, compressed=True)
        payload = await r.read()
        r.verify()
        return payload

    assert asyncio.run(read(pmemfs, w.objects, key)) == \
        asyncio.run(read(jmemfs, dict(w.objects), key)) == b"abc" * 100
    for mod, err in ((pmemfs, ft.IOError_), (jmemfs, fdb.IOError_)):
        with pytest.raises(err, match="no such object: sub/nope"):
            asyncio.run(read(mod, w.objects, "sub/nope.binpb"))
    bad = dict(w.objects)
    bad[key.replace("sub/", "sub/x")] = bad[key]
    with pytest.raises(ft.VerificationFailure):
        asyncio.run(read(pmemfs, bad, key.replace("sub/", "sub/x")))


# -- nbest ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 10, 50])
def test_nbest_matches_the_original(n):
    rng = np.random.default_rng(n)
    items = [(int(v), i) for i, v in enumerate(rng.integers(0, 20, 40))]
    key = lambda t: t[0]                                     # noqa: E731
    assert n_best_by_key(items, n, key) == \
        jnbest.n_best_by_key(items, n, key)
    mine, theirs = NBestByKey(n, key), jnbest.NBestByKey(n, key)
    for item in items:
        mine.push(item)
        theirs.push(item)
        assert mine.to_list() == theirs.to_list()
    assert len(mine) == len(theirs) and list(mine) == list(theirs)
    assert sorted(map(key, mine)) == sorted(map(key, items))[:n]


def test_nbest_rejects_a_non_positive_n():
    for mod in (jnbest, None):
        cls = NBestByKey if mod is None else mod.NBestByKey
        with pytest.raises(ValueError, match="n must be positive: 0"):
            cls(0, key=lambda t: t)
