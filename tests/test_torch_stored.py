"""The port's stored tier (``flechasdb_tpu_torch/serialize.py``,
``stored.py``, ``catalog.py``) against the JAX package's.

A small database is built by the JAX package on the CPU, given string and
uint64 attributes and one empty partition, and carried into the port by
``from_jax_arrays(device="cpu")``. Both packages save it: the trees must be
equal, file for file and byte for byte, and each package loads the
other's. Cold queries run the same host code in both, so their results
must be equal to the bit, with the same events and the same partitions
loaded. Warm queries (after ``preload``) run the port's device index on the
CPU and must agree within the JAX package's tolerance (rel 1e-4, abs 1e-5),
rows up to ties. Errors carry the JAX package's messages. The tests marked
``cuda`` run the warm path on the card and skip here.
"""

import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import catalog as jcatalog
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import serving as jserving
from flechasdb_tpu.memfs import MemoryFileSystem as JMemoryFileSystem
from flechasdb_tpu_torch import _kernels, host, serialize
from flechasdb_tpu_torch import stored as pstored

from _torch_helpers import (cuda, midpoint_radius, same_ranked,  # noqa
                            world_of_one)

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
def built(request):
    x, jdb = _jax_db(request.param)
    return request.param, x, jdb, ft.from_jax_arrays(jdb, device="cpu")


@pytest.fixture(scope="module")
def trees(built, tmp_path_factory):
    """Both packages' trees of the same database, in two directories."""
    metric, x, jdb, pdb = built
    base = tmp_path_factory.mktemp(f"trees-{metric}")
    roots = (ft.save_database(pdb, ft.LocalFileSystem(base / "port")),
             fdb.save_database(jdb, fdb.LocalFileSystem(base / "jax")))
    return base, roots


def _files(base):
    return {os.path.relpath(os.path.join(d, f), base):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(base) for f in fs}


def _load_both(base, root, device="cpu"):
    return (ft.load_database(ft.LocalFileSystem(base), f"{root}.binpb",
                             device=device),
            fdb.load_database(fdb.LocalFileSystem(base), f"{root}.binpb"))


def _queries(x, n=6, seed=8):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    return (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)


def _fields(results):
    return [(r.vector_id, r.partition_index, r.vector_index,
             r.squared_distance) for r in results]


def _event(e):
    return type(e).__name__, dataclasses.asdict(e)


def _loaded(sdb):
    return [i for i, p in enumerate(sdb._partitions) if p is not None]


# -- save ---------------------------------------------------------------------

def test_save_is_byte_identical_to_jax(built, trees):
    metric, _, jdb, pdb = built
    base, (root, jroot) = trees
    assert root == jroot
    port, jax_ = _files(base / "port"), _files(base / "jax")
    assert port == jax_
    kinds = {k.split("/")[0] for k in port if "/" in k}
    assert kinds == {"partitions", "codebooks", "attributes"}
    # one root, P partitions + the centroids, D codebooks, P attribute logs
    assert len(port) == 1 + (P + 1) + D + P
    got, want = ft.MemoryFileSystem(), JMemoryFileSystem()
    assert ft.save_database(pdb, got) == fdb.save_database(jdb, want) == root
    assert got.objects == want.objects


def test_saved_bytes_do_not_depend_on_the_pool(built, monkeypatch):
    _, _, _, pdb = built
    trees_ = []
    for workers in (1, 8):
        monkeypatch.setattr(serialize, "_pack_workers", lambda t, w=workers:
                            w)
        fs = ft.MemoryFileSystem()
        trees_.append((ft.save_database(pdb, fs), fs.objects))
    assert trees_[0] == trees_[1]


def test_pools_are_sized_from_the_schedulable_set(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1},
                        raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    assert host.usable_cpus() == 2
    assert serialize._pack_workers(100) == 2
    assert pstored._query_io_threads()
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3},
                        raising=False)
    assert serialize._pack_workers(100) == 1
    assert not pstored._query_io_threads()

    def unsupported(pid):
        raise AttributeError

    monkeypatch.setattr(os, "sched_getaffinity", unsupported)
    assert host.usable_cpus() == 64
    assert serialize._pack_workers(3) == 3


# -- load ---------------------------------------------------------------------

def test_each_package_loads_the_others_tree(built, trees):
    metric, x, _, _ = built
    base, (root, _) = trees
    mine = ft.load_database(ft.LocalFileSystem(base / "jax"),
                            f"{root}.binpb", device="cpu")
    theirs = fdb.load_database(fdb.LocalFileSystem(base / "port"),
                               f"{root}.binpb")
    assert mine.metric == theirs.metric == metric
    assert mine.attribute_names == theirs.attribute_names == \
        ["lang", "tenant"]
    for v in _queries(x, 3):
        assert _fields(mine.query(v, K, NPROBE)) == \
            _fields(theirs.query(v, K, NPROBE))
    got, want = mine.to_database(), theirs.to_database()
    assert got.device == "cpu" and got.residues is None
    for name in ("partition_centroids", "codebooks", "codes",
                 "partition_indices"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert got.vector_ids == want.vector_ids
    assert got.attribute_table == want.attribute_table


# -- cold queries ---------------------------------------------------------------

def test_cold_query_matches_jax_to_the_bit(built, trees):
    """Same rows, bit-equal distances, same events; only the probed
    partitions load."""
    metric, x, _, _ = built
    base, (root, _) = trees
    mine, theirs = _load_both(base / "port", root)
    probed = set()
    for i, v in enumerate(_queries(x)):
        ev_mine, ev_theirs = [], []
        got = mine.query_with_events(v, K, NPROBE, ev_mine.append)
        want = theirs.query_with_events(v, K, NPROBE, ev_theirs.append)
        assert _fields(got) == _fields(want)
        assert [_event(e) for e in ev_mine] == [_event(e) for e in ev_theirs]
        probed |= {e.partition_index for e in ev_mine
                   if type(e).__name__ == "StartingPartitionQuery"}
        assert _loaded(mine) == _loaded(theirs) == sorted(probed)
        assert _fields(mine.query(v, K, NPROBE)) == _fields(got)
        if i == 0:
            assert len(_loaded(mine)) == NPROBE < P


def test_cold_filter_range_and_attributes_match_jax(built, trees):
    metric, x, jdb, _ = built
    base, (root, _) = trees
    mine, theirs = _load_both(base / "port", root)
    where_mine = ft.Eq("tenant", 1) | ft.Eq("lang", "ja")
    where_theirs = fdb.filters.Eq("tenant", 1) | fdb.filters.Eq("lang", "ja")
    for v in _queries(x, 4):
        got = mine.query(v, K, NPROBE, where=where_mine)
        assert _fields(got) == _fields(theirs.query(v, K, NPROBE,
                                                    where=where_theirs))
        for r in got:
            assert r.get_attribute("tenant") == 1 or \
                r.get_attribute("lang") == "ja"
        keys = [r.squared_distance for r in mine.query(v, 2 * K, NPROBE)]
        radius = midpoint_radius(keys, 0.5)
        for kw in ({}, {"limit": 3}, {"where": "f"}):
            kw_m = dict(kw, where=where_mine) if kw.get("where") else kw
            kw_t = dict(kw, where=where_theirs) if kw.get("where") else kw
            assert _fields(mine.query_range(v, radius, NPROBE, **kw_m)) == \
                _fields(theirs.query_range(v, radius, NPROBE, **kw_t))
    for r in mine.query(x[0], K, P):
        for key in ("tenant", "lang", "missing"):
            assert r.get_attribute(key) == jdb.attribute_table.get(
                r.vector_id, {}).get(key)
    for vid, attrs in list(jdb.attribute_table.items())[:20]:
        assert mine.get_attribute(vid, "tenant") == \
            theirs.get_attribute(vid, "tenant") == attrs["tenant"]


# -- warm queries ---------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bucketed", "masked"])
def test_warm_query_batch_matches_jax(built, trees, layout, monkeypatch):
    metric, x, _, _ = built
    base, (root, _) = trees
    if layout == "masked":      # both policies then pick the masked scan
        monkeypatch.setattr(host, "PAD_LIMIT", 0.0)
        monkeypatch.setattr(jserving, "PAD_LIMIT", 0.0)
    mine, theirs = _load_both(base / "port", root)
    events = []
    mine.preload(events=events.append)
    theirs.preload()
    assert mine._dev[0].layout == layout
    assert len(_loaded(mine)) == P
    assert sorted(map(repr, events)) == sorted(
        [f"StartingPartitionLoad(partition_index={i})" for i in range(P)]
        + [f"FinishedPartitionLoad(partition_index={i})" for i in range(P)])
    q = _queries(x, 12)
    row_of = {vid: i for i, vid in enumerate(mine._dev[3])}

    def arrays(results, k):
        d = np.full((len(results), k), np.inf, np.float32)
        r = np.full((len(results), k), -1, np.int64)
        for b, rs in enumerate(results):
            d[b, :len(rs)] = [x.squared_distance for x in rs]
            r[b, :len(rs)] = [row_of[x.vector_id] for x in rs]
        return d, r

    for where in (None, "f"):
        wm = None if where is None else ft.Eq("tenant", 2)
        wt = None if where is None else fdb.filters.Eq("tenant", 2)
        got = mine.query_batch(q, K, NPROBE, where=wm)
        want = theirs.query_batch(q, K, NPROBE, where=wt)
        same_ranked(*arrays(got, K), *arrays(want, K))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if a.vector_id == b.vector_id:
                    assert (a.partition_index, a.vector_index) == \
                        (b.partition_index, b.vector_index)
        single = [mine.query(v, K, NPROBE, where=wm) for v in q]
        same_ranked(*arrays(single, K), *arrays(got, K))
    v = q[0]
    keys = [r.squared_distance for r in mine.query(v, 2 * K, NPROBE)]
    radius = midpoint_radius(keys, 0.5)
    got = mine.query_range(v, radius, NPROBE)
    want = theirs.query_range(v, radius, NPROBE)
    assert {r.vector_id for r in got} == {r.vector_id for r in want}
    same_ranked(*arrays([got], len(want)), *arrays([want], len(want)))
    assert len(mine.query_range(v, radius, NPROBE, limit=2)) == \
        min(2, len(want))


def test_warm_query_events_match_jax(built, trees):
    _, x, _, _ = built
    base, (root, _) = trees
    mine, theirs = _load_both(base / "port", root)
    mine.preload()
    theirs.preload()
    ev_mine, ev_theirs = [], []
    mine.query_with_events(x[1], K, NPROBE, ev_mine.append)
    theirs.query_with_events(x[1], K, NPROBE, ev_theirs.append)
    assert [_event(e) for e in ev_mine] == [_event(e) for e in ev_theirs]


def test_query_batch_preloads_on_first_use(built, trees):
    _, x, _, pdb = built
    base, (root, _) = trees
    mine, _ = _load_both(base / "port", root)
    got = mine.query_batch(x[:4], K, NPROBE)
    assert mine._dev is not None and mine._dev[0].device.type == "cpu"
    want = pdb.query_batch(x[:4], K, NPROBE)
    for g, w in zip(got, want):
        assert [r.vector_id for r in g] == [r.vector_id for r in w]
        assert [r.squared_distance for r in g] == \
            [r.squared_distance for r in w]


def test_concurrent_preload_fills_every_partition(built, trees):
    """Many workers load into their own slots: every partition arrives
    once, equal to a serial load, under a short switch interval."""
    _, _, _, _ = built
    base, (root, _) = trees
    serial, _ = _load_both(base / "port", root)
    serial._load_all_partitions(max_workers=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            mine, _ = _load_both(base / "port", root)
            t0 = time.monotonic()
            parts = mine._load_all_partitions(max_workers=32)
            assert time.monotonic() - t0 < 30
            assert len(parts) == P and _loaded(mine) == list(range(P))
            for a, b in zip(parts, serial._partitions):
                np.testing.assert_array_equal(a.codes, b.codes)
                assert a.vector_ids == b.vector_ids
    finally:
        sys.setswitchinterval(old)
    with ThreadPoolExecutor(8) as ex:
        mine, _ = _load_both(base / "port", root)
        got = list(ex.map(mine.get_partition, [0, 1, 0, 1, 3, 3, 4, 5]))
    assert all(p is not None for p in got)


# -- errors ---------------------------------------------------------------------

def _raises_alike(call_mine, call_theirs, mine_err, theirs_err):
    with pytest.raises(mine_err) as a:
        call_mine()
    with pytest.raises(theirs_err) as b:
        call_theirs()
    assert str(a.value) == str(b.value)
    return str(a.value)


def test_errors_carry_the_jax_messages(built, trees):
    metric, x, _, _ = built
    base, (root, _) = trees
    mine, theirs = _load_both(base / "port", root)
    v, bad_v = x[0], np.zeros(M + 1, np.float32)
    cases = [
        lambda db: db.query(v, 0, 1),
        lambda db: db.query(v, K, 0),
        lambda db: db.query(v, K, P + 1),
        lambda db: db.query(bad_v, K, 1),
        lambda db: db.query_range(v, float("inf"), 1),
        lambda db: db.query_range(v, 1.0, 0),
        lambda db: db.query_range(bad_v, 1.0, 1),
        lambda db: db.query_batch(x[:2], -1, 1),
        lambda db: db.query_batch(np.zeros((2, M - 1), np.float32), K, 1),
        lambda db: db.get_partition(P),
        lambda db: db.get_attribute(__import__("uuid").UUID(int=7), "x"),
    ]
    if metric == "cosine":
        cases.append(lambda db: db.query(np.zeros(M, np.float32), K, 1))
    for case in cases:
        _raises_alike(lambda: case(mine), lambda: case(theirs),
                      ft.InvalidArgs, jerrors.InvalidArgs)


def test_corrupt_trees_raise_the_jax_errors(built, trees, tmp_path):
    _, x, _, pdb = built
    base, (root, _) = trees
    fs = ft.MemoryFileSystem()
    root = ft.save_database(pdb, fs)
    jfs = JMemoryFileSystem(dict(fs.objects))
    name = f"{root}.binpb"
    flipped = bytearray(fs.objects[name])
    flipped[len(flipped) // 2] ^= 0x10
    for f in (fs, jfs):
        f.objects[name] = bytes(flipped)
    _raises_alike(lambda: ft.load_database(fs, name, device="cpu"),
                  lambda: fdb.load_database(jfs, name),
                  (ft.VerificationFailure, ft.IOError_),
                  (jerrors.VerificationFailure, jerrors.IOError_))
    # a root that verifies but breaks an invariant
    for bad in (dict(vector_size=0), dict(num_divisions=3),
                dict(partition_ids=["a", "b"]), dict(metric="hamming")):
        fields = dict(vector_size=M, num_partitions=1, num_divisions=D,
                      num_codes=C, partition_ids=["p"],
                      codebook_ids=["c"] * D)
        fields.update(bad)
        for f, protos in ((fs, ft.protos), (jfs, fdb.protos)):
            w = f.create_hashed_file(compress=True)
            w.write(protos.PDatabase(**fields).encode())
            h = w.persist()
        _raises_alike(lambda: ft.load_database(fs, f"{h}.binpb"),
                      lambda: fdb.load_database(jfs, f"{h}.binpb"),
                      ft.InvalidData, jerrors.InvalidData)
    # a partition file with one byte flipped fails its query
    dirs = tmp_path / "copy"
    for rel, data in _files(base / "port").items():
        path = dirs / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        raw = bytearray(data)
        if rel.startswith("partitions/") and len(raw) > 200:
            raw[len(raw) // 2] ^= 0x01
        path.write_bytes(bytes(raw))
    mine, theirs = _load_both(dirs, trees[1][0])
    _raises_alike(lambda: mine.preload(), lambda: theirs.preload(),
                  (ft.VerificationFailure, ft.IOError_),
                  (jerrors.VerificationFailure, jerrors.IOError_))
    # one byte that keeps the stream inflating (the zlib header's level
    # hint, 0x9C -> 0xDA): only the content hash catches it
    path = base / "port" / "partitions" / f"{mine.root.partition_ids[1]}.binpb"
    raw = bytearray(path.read_bytes())
    assert raw[:2] == b"\x78\x9c"
    raw[1] = 0xDA
    (dirs / "partitions" / path.name).write_bytes(bytes(raw))
    mine, theirs = _load_both(dirs, trees[1][0])
    msg = _raises_alike(lambda: mine.get_partition(1),
                        lambda: theirs.get_partition(1),
                        ft.VerificationFailure, jerrors.VerificationFailure)
    assert msg.startswith(f"Expected hash '{path.stem}'")


def test_unported_options_raise_and_name_their_item(built, trees):
    _, x, _, _ = built
    base, (root, _) = trees
    mine, _ = _load_both(base / "port", root)
    with pytest.raises(ft.InvalidArgs, match="residues were not retained"):
        mine.to_database().reconstruct(0)
    with pytest.raises(ft.InvalidArgs, match="rerank requires"):
        mine.to_database().query_batch(x[:2], K, NPROBE, rerank=10)


@pytest.mark.parametrize("layout", ["bucketed", "masked"])
def test_preload_mesh_equals_preload(built, trees, world_of_one, layout,
                                     monkeypatch):
    """``preload(mesh=)`` on a world of one serves a ``ShardedIndex`` whose
    results, ranges and filtered batches are ``preload()``'s, bit for bit,
    on both layouts."""
    _, x, _, _ = built
    base, (root, _) = trees
    from flechasdb_tpu_torch import serving
    monkeypatch.setattr(serving, "choose_layout", lambda *a: layout)
    mine, _ = _load_both(base / "port", root)
    plain, _ = _load_both(base / "port", root)
    mine.preload(mesh=world_of_one)
    plain.preload()
    assert mine._dev[0].layout == f"sharded-{layout}"
    q = _queries(x, 16)
    for got, want in ((mine.query_batch(q, K, NPROBE),
                       plain.query_batch(q, K, NPROBE)),
                      ([mine.query(q[0], K, NPROBE)],
                       [plain.query(q[0], K, NPROBE)])):
        for g, w in zip(got, want):
            assert [(r.vector_id, r.partition_index, r.vector_index,
                     r.squared_distance) for r in g] == \
                [(r.vector_id, r.partition_index, r.vector_index,
                  r.squared_distance) for r in w]
    keys = [r.squared_distance for r in plain.query(q[1], 20, P)]
    radius = midpoint_radius(keys, 0.5)
    assert [(r.vector_id, r.squared_distance)
            for r in mine.query_range(q[1], radius, P)] == \
        [(r.vector_id, r.squared_distance)
         for r in plain.query_range(q[1], radius, P)]


# -- updates --------------------------------------------------------------------

def test_update_then_resave_touches_only_changed_partitions(built, tmp_path):
    metric, x, _, pdb = built
    fs = ft.LocalFileSystem(tmp_path)
    root = ft.save_database(pdb, fs)
    before = {p: p.stat().st_mtime_ns for p in tmp_path.rglob("*.binpb")}
    mem = ft.load_database(fs, f"{root}.binpb", device="cpu").to_database()
    assert ft.save_database(mem, fs) == root
    assert {p: p.stat().st_mtime_ns
            for p in tmp_path.rglob("*.binpb")} == before

    rng = np.random.default_rng(11)
    added = mem.add_vectors(rng.standard_normal((7, M)).astype(np.float32),
                            seed=3)
    touched = set(mem.partition_indices[-7:].tolist())
    root2 = ft.save_database(mem, fs)
    s1 = ft.load_database(fs, f"{root}.binpb", device="cpu")
    s2 = ft.load_database(fs, f"{root2}.binpb", device="cpu")
    for pi in range(P):
        same = s1.root.partition_ids[pi] == s2.root.partition_ids[pi]
        assert same == (pi not in touched), (pi, touched)
    mem2 = s2.to_database()
    assert set(added) <= set(mem2.vector_ids)

    victims = [mem2.vector_ids[0], mem2.vector_ids[-1]]
    lost = {int(mem2.partition_indices[0]), int(mem2.partition_indices[-1])}
    assert mem2.remove_vectors(victims) == 2
    root3 = ft.save_database(mem2, fs)
    s3 = ft.load_database(fs, f"{root3}.binpb", device="cpu")
    for pi in range(P):
        same = s2.root.partition_ids[pi] == s3.root.partition_ids[pi]
        assert same == (pi not in lost), (pi, lost)
    # the JAX package reads the updated tree as the port wrote it
    jmem = fdb.load_database(fdb.LocalFileSystem(tmp_path),
                             f"{root3}.binpb").to_database()
    assert jmem.vector_ids == s3.to_database().vector_ids
    with pytest.raises(jerrors.InvalidArgs):
        jmem.get_attribute(victims[0], "tenant")


# -- catalog --------------------------------------------------------------------

def test_labels_publish_resolve_and_load(built, tmp_path):
    _, x, _, pdb = built
    fs = ft.LocalFileSystem(tmp_path)
    root = ft.save_database(pdb, fs)
    ft.publish_label(fs, root)
    ft.publish_label(fs, root, name="v1.0")
    assert ft.resolve_label(fs) == ft.resolve_label(fs, "v1.0") == root
    assert jcatalog.resolve_label(fdb.LocalFileSystem(tmp_path)) == root
    sdb = ft.load_labeled(fs, device="cpu")
    assert isinstance(sdb, ft.StoredDatabase) and sdb.device == "cpu"
    assert _fields(sdb.query(x[0], K, NPROBE)) == _fields(
        fdb.load_database(fdb.LocalFileSystem(tmp_path),
                          f"{root}.binpb").query(x[0], K, NPROBE))
    jfs = fdb.LocalFileSystem(tmp_path)
    for mine, theirs, err in [
            (lambda: ft.publish_label(fs, root, name="-bad"),
             lambda: jcatalog.publish_label(jfs, root, name="-bad"),
             "InvalidArgs"),
            (lambda: ft.publish_label(fs, "a/b"),
             lambda: jcatalog.publish_label(jfs, "a/b"), "InvalidArgs"),
            (lambda: ft.publish_label(fs, "nothere"),
             lambda: jcatalog.publish_label(jfs, "nothere"), "IOError_"),
            (lambda: ft.resolve_label(fs, "none"),
             lambda: jcatalog.resolve_label(jfs, "none"), "InvalidArgs")]:
        _raises_alike(mine, theirs, getattr(ft, err), getattr(jerrors, err))
    mfs = ft.MemoryFileSystem()
    root = ft.save_database(pdb, mfs)
    ft.publish_label(mfs, root, name="latest")
    assert mfs.read_named("labels/latest") == f"{root}\n".encode()
    assert ft.load_labeled(mfs, device="cpu").num_partitions == P


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_preload_on_card_matches_cpu_and_launches_the_scan(cuda, built,
                                                           trees):
    _, x, _, _ = built
    base, (root, _) = trees
    card, _ = _load_both(base / "port", root, device="cuda")
    cpu, _ = _load_both(base / "port", root)
    card.preload()
    cpu.preload()
    assert card._dev[0].device.type == "cuda"
    assert card._dev[0].layout == "bucketed"
    q = _queries(x, 16)
    _kernels.reset_launches()
    got = card.query_batch(q, K, NPROBE)
    assert _kernels.LAUNCHES["adc_scan"] > 0
    want = cpu.query_batch(q, K, NPROBE)
    for g, w in zip(got, want):
        assert [r.vector_id for r in g] == [r.vector_id for r in w]
        np.testing.assert_allclose([r.squared_distance for r in g],
                                   [r.squared_distance for r in w],
                                   rtol=1e-4, atol=1e-5)
    before = _kernels.LAUNCHES["adc_scan"]
    card.query(q[0], K, NPROBE)
    card.query_range(q[0], 1.0, NPROBE)
    assert _kernels.LAUNCHES["adc_scan"] >= before + 2
    assert card.to_database().device.startswith("cuda")
    torch.cuda.synchronize()


def test_events_are_the_jax_classes():
    from flechasdb_tpu import events as jevents
    from flechasdb_tpu_torch import events

    def classes(mod):
        return {name: list(getattr(obj, "__dataclass_fields__", []))
                for name, obj in vars(mod).items()
                if isinstance(obj, type) and issubclass(obj, mod.Event)}

    assert classes(events) == classes(jevents)
    assert len(classes(events)) == 30
