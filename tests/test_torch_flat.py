"""The port's flat (exact-search) tier (``flechasdb_tpu_torch/ops/exact.py``,
``flat.py``) against the JAX package's.

The same arrays and seed go through both packages on the CPU. The tolerance
is the JAX package's own (``tests/test_stored.py:266``): distances within
rel 1e-4, abs 1e-5; rows equal, except where two rows' distances tie
(within rel 1e-6), where either order is right. On integer-valued data
every distance is exact in f32 in both packages, so there the rows must be
equal outright, tie order included. Saved trees must be equal byte for
byte. The tests marked ``cuda`` run the scan on the card against the CPU
path and skip here.
"""

import asyncio
import os
import uuid
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import flat as jflat
from flechasdb_tpu.asyncdb import AsyncLocalFileSystem as JAsyncLocalFS
from flechasdb_tpu.ops.exact import exact_topk as jexact_topk
from flechasdb_tpu_torch import flat as pflat
from flechasdb_tpu_torch.asyncdb import AsyncLocalFileSystem
from flechasdb_tpu_torch.ops.exact import exact_topk

from _torch_helpers import (cuda, midpoint_radius, same_ranked,  # noqa
                            world_of_one)

N, M, K = 500, 24, 5
FIXTURES = Path(__file__).parent / "fixtures"
FLATGOLDEN = FIXTURES / "flatgolden"


def _files(base):
    return {os.path.relpath(os.path.join(d, f), base):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(base) for f in fs}


def _both_topk(q, x, mask, **kw):
    jd, ji = jexact_topk(jnp.asarray(q), jnp.asarray(x),
                         None if mask is None else jnp.asarray(mask), **kw)
    pd, pi = exact_topk(torch.from_numpy(q), torch.from_numpy(x),
                        None if mask is None else torch.from_numpy(mask),
                        **kw)
    assert pi.dtype == torch.int32 and pd.dtype == torch.float32
    return (np.asarray(jd), np.asarray(ji)), (pd.numpy(), pi.numpy())


# -- ops/exact.exact_topk ------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, chunk, k", [
    (500, 1 << 17, 7),          # one chunk
    (500, 128, 7),              # 500 = 3·128 + 116: the shifted last chunk
    (50, 64, 80),               # k > N: +inf and row 0 past N
])
def test_exact_topk_matches_jax(metric, masked, n, chunk, k):
    rng = np.random.default_rng(n + chunk + k)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    mask = rng.random(n) < 0.6 if masked else None
    (jd, ji), (pd, pi) = _both_topk(q, x, mask, k=k, chunk=chunk,
                                    metric=metric)
    same_ranked(pd, pi, jd, ji)
    np.testing.assert_array_equal(pi[np.isinf(pd)], 0)
    if mask is not None:
        assert mask[pi[np.isfinite(pd)]].all()


def test_exact_topk_empty_corpus():
    q = np.ones((3, 8), np.float32)
    (jd, ji), (pd, pi) = _both_topk(q, np.zeros((0, 8), np.float32), None,
                                    k=4)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pi, ji)
    assert np.isinf(pd).all() and (pi == 0).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_exact_topk_tie_order_on_duplicated_rows(metric):
    """Integer-valued rows, each one duplicated 90 rows later, under a
    chunk that does not divide N: every key is exact in f32, so the rows
    must equal the JAX package's, the lower row first among equal keys,
    also across chunk boundaries."""
    rng = np.random.default_rng(21)
    x = rng.integers(-2, 3, (270, 8)).astype(np.float32)
    x[90:180] = x[:90]
    q = rng.integers(-2, 3, (7, 8)).astype(np.float32)
    (jd, ji), (pd, pi) = _both_topk(q, x, None, k=12, chunk=100,
                                    metric=metric)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pi, ji)
    keys = (((q[:, None] - x[None]) ** 2).sum(-1) if metric == "l2"
            else -(q @ x.T))
    want = np.argsort(keys, axis=1, kind="stable")[:, :12]
    np.testing.assert_array_equal(pi, want)


# -- FlatDatabase ----------------------------------------------------------------

@pytest.fixture(params=["l2", "dot", "cosine"])
def pair(request):
    """The same arrays and seed in both packages, attributes on every third
    row."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((N, M)).astype(np.float32)
    jdb = jflat.FlatDatabase(x, seed=1, metric=request.param)
    pdb = ft.FlatDatabase(x, seed=1, metric=request.param, device="cpu")
    for db in (jdb, pdb):
        for i in range(0, N, 3):
            db.set_attribute_at(i, ("datum_id", i))
            db.set_attribute_at(i, ("tenant", ["a", "b"][i % 2]))
    return request.param, x, jdb, pdb


def _queries(x, n=7, seed=8):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    return (q + 0.1 * rng.standard_normal(q.shape)).astype(np.float32)


def _same(got, want):
    """Two flat result lists: rows and ids equal up to distance ties,
    distances within the tolerance."""
    assert len(got) == len(want)
    same_ranked(np.array([r.squared_distance for r in got]),
                np.array([r.vector_index for r in got]),
                np.array([r.squared_distance for r in want]),
                np.array([r.vector_index for r in want]))
    for g, w in zip(got, want):
        if g.vector_index == w.vector_index:
            assert g.vector_id == w.vector_id


def test_flat_ids_and_queries_match_jax(pair):
    metric, x, jdb, pdb = pair
    assert pdb.vector_ids == jdb.vector_ids
    assert pdb.metric == jdb.metric
    np.testing.assert_array_equal(pdb.vectors, jdb.vectors)
    q = _queries(x)
    for got, want in zip(pdb.query_batch(q, K), jdb.query_batch(q, K)):
        _same(got, want)
        assert [r.get_attribute("datum_id") for r in got] == \
            [r.get_attribute("datum_id") for r in want]
    _same(pdb.query(q[0], K), jdb.query(q[0], K))
    # k > N: the reachable rows only
    assert len(pdb.query(q[0], N + 10)) == N


def test_flat_filters_and_range_match_jax(pair):
    metric, x, jdb, pdb = pair
    q = _queries(x)
    for mine, theirs in ((ft.Eq("tenant", "a"), fdb.Eq("tenant", "a")),
                         (ft.Range("datum_id", 30, 300),
                          fdb.Range("datum_id", 30, 300)),
                         (ft.Eq("tenant", "zz"), fdb.Eq("tenant", "zz"))):
        got = pdb.query_batch(q, K, where=mine)
        want = jdb.query_batch(q, K, where=theirs)
        for g, w in zip(got, want):
            _same(g, w)
    plain = jdb.query_batch(q, 12)
    for b, v in enumerate(q):
        # halfway between two distinct keys: no key lies near the radius
        radius = (plain[b][9].squared_distance
                  + plain[b][10].squared_distance) / 2
        for kw in ({}, {"limit": 4},
                   {"where": fdb.Eq("tenant", "b")}):
            pkw = dict(kw)
            if "where" in kw:
                pkw["where"] = ft.Eq("tenant", "b")
            _same(pdb.query_range(v, radius, **pkw),
                  jdb.query_range(v, radius, **kw))


def test_flat_updates_match_jax(pair):
    metric, x, jdb, pdb = pair
    rng = np.random.default_rng(4)
    new = rng.standard_normal((20, M)).astype(np.float32)
    assert pdb.append(new) == jdb.append(new)
    assert pdb.vector_ids == jdb.vector_ids
    q = _queries(x)
    pdb.query_batch(q, K, where=ft.Eq("tenant", "a"))   # warm the cache
    doomed = pdb.vector_ids[:40:2]
    assert pdb.remove(doomed) == jdb.remove(doomed) == 20
    assert pdb.vector_ids == jdb.vector_ids
    np.testing.assert_array_equal(pdb.vectors, jdb.vectors)
    for got, want in zip(pdb.query_batch(new[:5], K),
                         jdb.query_batch(new[:5], K)):
        _same(got, want)
    got = pdb.query_batch(q, K, where=ft.Eq("tenant", "a"))
    want = jdb.query_batch(q, K, where=fdb.Eq("tenant", "a"))
    for g, w in zip(got, want):
        _same(g, w)
    assert pdb.remove([]) == 0


def test_flat_errors_carry_the_jax_messages(pair):
    metric, x, jdb, pdb = pair
    calls = [
        lambda db: db.query(x[0], 0),
        lambda db: db.query(x[0, :5], 3),
        lambda db: db.query_range(x[0], float("inf")),
        lambda db: db.query_range(x[0, :5], 1.0),
        lambda db: db.append(x[:3, :7]),
        lambda db: db.append(x[:3], vector_ids=[uuid.uuid4()]),
        lambda db: db.remove([uuid.UUID(int=5)]),
        lambda db: db.set_attribute_at(N + 5, ("k", 1)),
        lambda db: db.get_attribute(uuid.UUID(int=5), "k"),
    ]
    for call in calls:
        with pytest.raises(fdb.InvalidArgs) as theirs:
            call(jdb)
        with pytest.raises(ft.InvalidArgs) as mine:
            call(pdb)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ft.InvalidArgs, match="IDs for"):
        ft.FlatDatabase(x, vector_ids=[uuid.uuid4()], device="cpu")
    with pytest.raises(ft.InvalidArgs, match="unknown metric"):
        ft.FlatDatabase(x, metric="hamming", device="cpu")


def test_flat_preload_mesh_equals_unsharded(pair, tmp_path, world_of_one):
    """Both flat tiers' ``preload(mesh=)`` on a world of one: exact
    batches (filtered too) and range hits equal the unsharded tier's, the
    corpus held as the rank's block; an append re-places it under the
    same mesh."""
    _, x, _, pdb = pair
    root = ft.save_flat_database(pdb, ft.LocalFileSystem(tmp_path))
    sdb = ft.load_flat_database(ft.LocalFileSystem(tmp_path),
                                f"{root}.binpb", device="cpu")
    plain = ft.FlatDatabase(x, seed=1, metric=pdb.metric, device="cpu")
    for i in range(0, N, 3):
        plain.set_attribute_at(i, ("tenant", ["a", "b"][i % 2]))
    q = _queries(x)
    where = ft.Eq("tenant", "a")
    want = [plain.query_batch(q, 5), plain.query_batch(q, 5, where=where)]
    keys = [r.squared_distance for r in plain.query(q[0], 40)]
    radius = midpoint_radius(keys, 0.5)
    want_range = plain.query_range(q[0], radius)
    for db in (pdb, sdb):
        db.preload(mesh=world_of_one)
        assert db._mesh is world_of_one
        got = [db.query_batch(q, 5), db.query_batch(q, 5, where=where)]
        for g, w in zip(got, want):
            assert [[(r.vector_id, r.squared_distance) for r in rs]
                    for rs in g] == [[(r.vector_id, r.squared_distance)
                                      for r in rs] for rs in w]
        assert [(r.vector_id, r.squared_distance)
                for r in db.query_range(q[0], radius)] == \
            [(r.vector_id, r.squared_distance) for r in want_range]
    plain.append(x[:3], pdb.append(x[:3]))
    assert pdb._dev is None
    assert [(r.vector_id, r.squared_distance)
            for r in pdb.query_batch(q[:1], 9)[0]] == \
        [(r.vector_id, r.squared_distance)
         for r in plain.query_batch(q[:1], 9)[0]]
    assert pdb._mesh is world_of_one and len(pdb._dev) == N + 3


def test_flat_on_a_missing_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("holds only where CUDA is missing")
    x = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    db = ft.FlatDatabase(x, seed=1)
    assert db.device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        db.query(x[0], 3)
    assert db._dev is None


# -- save and load ----------------------------------------------------------------

def test_flat_save_is_byte_identical_and_cross_loads(pair, tmp_path):
    metric, x, jdb, pdb = pair
    root = ft.save_flat_database(pdb, ft.LocalFileSystem(tmp_path / "port"))
    jroot = jflat.save_flat_database(jdb,
                                     fdb.LocalFileSystem(tmp_path / "jax"))
    assert root == jroot
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    q = _queries(x)
    mine = ft.load_flat_database(ft.LocalFileSystem(tmp_path / "jax"),
                                 f"{root}.binpb", device="cpu")
    theirs = fdb.load_flat_database(fdb.LocalFileSystem(tmp_path / "port"),
                                    f"{root}.binpb")
    assert mine.num_vectors == N and mine.metric == metric
    for got, want in zip(mine.query_batch(q, K), theirs.query_batch(q, K)):
        _same(got, want)
        assert [r.get_attribute("tenant") for r in got] == \
            [r.get_attribute("tenant") for r in want]
    got = mine.query_batch(q, K, where=ft.Eq("tenant", "a"))
    want = theirs.query_batch(q, K, where=fdb.Eq("tenant", "a"))
    for g, w in zip(got, want):
        _same(g, w)
    assert mine.get_attribute(pdb.vector_ids[3], "datum_id") == 3
    assert mine.get_attribute(pdb.vector_ids[4], "datum_id") is None
    with pytest.raises(ft.InvalidArgs, match="no such vector ID"):
        mine.get_attribute(uuid.UUID(int=7), "datum_id")


def test_flat_stored_tiers_equal_the_in_memory_database(pair, tmp_path):
    metric, x, _, pdb = pair
    fs = ft.LocalFileSystem(tmp_path)
    root = ft.save_flat_database(pdb, fs)
    sdb = ft.load_flat_database(fs, f"{root}.binpb", device="cpu")
    assert sdb.device == "cpu" and sdb._dev is None
    sdb.preload()
    assert sdb._dev[0].device.type == "cpu"
    q = _queries(x)
    want = pdb.query_batch(q, K)

    def fields(rs):
        return [(r.vector_id, r.vector_index, r.squared_distance)
                for r in rs]

    assert [fields(r) for r in sdb.query_batch(q, K)] == \
        [fields(r) for r in want]
    mat = sdb.to_database()
    assert mat.device == "cpu" and mat.metric == metric
    assert ft.save_flat_database(mat, ft.MemoryFileSystem()) == root

    async def go():
        adb = await ft.load_flat_database_async(AsyncLocalFileSystem(tmp_path),
                                                f"{root}.binpb", device="cpu")
        return [await adb.query(v, K) for v in q]

    # one query at a time, as the async tier scans (a product's bits
    # depend on the batch's size)
    assert [fields(r) for r in asyncio.run(go())] == \
        [fields(pdb.query(v, K)) for v in q]


def test_flat_multichunk_and_foreign_chunking(tmp_path, monkeypatch):
    """Chunks of the JAX package's size are not pinned by the format: a
    tree written with another chunking loads and replays its attribute
    logs against the right rows, in both stored tiers of the port."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    jdb = jflat.FlatDatabase(x, seed=2)
    jdb.set_attribute_at(250, ("tag", "late-chunk"))
    monkeypatch.setattr(jflat, "CHUNK_ROWS", 128)
    root = jflat.save_flat_database(jdb, fdb.LocalFileSystem(tmp_path))
    sdb = ft.load_flat_database(ft.LocalFileSystem(tmp_path),
                                f"{root}.binpb", device="cpu")
    assert len(sdb.root.chunk_ids) == 3
    res = sdb.query(x[250], k=1)
    assert res[0].vector_id == jdb.vector_ids[250]
    assert res[0].get_attribute("tag") == "late-chunk"
    monkeypatch.setattr(pflat, "CHUNK_ROWS", 128)
    pdb = ft.FlatDatabase(x, seed=2, device="cpu")
    pdb.set_attribute_at(250, ("tag", "late-chunk"))
    assert ft.save_flat_database(pdb, ft.MemoryFileSystem()) == root

    async def go():
        adb = await ft.load_flat_database_async(
            AsyncLocalFileSystem(tmp_path), f"{root}.binpb", device="cpu")
        assert await adb.get_attribute(jdb.vector_ids[250], "tag") == \
            "late-chunk"
        assert await adb.get_attribute(jdb.vector_ids[10], "tag") is None
        filt = await adb.query(x[250], 3, where=ft.Exists("tag"))
        assert [r.vector_index for r in filt] == [250]
        return True

    assert asyncio.run(go())


def test_flat_corrupt_chunk_raises(pair, tmp_path):
    _, x, _, pdb = pair
    root = ft.save_flat_database(pdb, ft.LocalFileSystem(tmp_path))
    chunk = next((tmp_path / "chunks").iterdir())
    data = bytearray(chunk.read_bytes())
    data[3] ^= 0xFF
    chunk.write_bytes(bytes(data))
    sdb = ft.load_flat_database(ft.LocalFileSystem(tmp_path),
                                f"{root}.binpb", device="cpu")
    with pytest.raises((ft.VerificationFailure, ft.IOError_)):
        sdb.query(x[0], k=3)


# -- the async flat tier ------------------------------------------------------

def test_async_flat_matches_jax(pair, tmp_path):
    metric, x, jdb, pdb = pair
    root = ft.save_flat_database(pdb, ft.LocalFileSystem(tmp_path))
    q = _queries(x, n=3)
    radius = (jdb.query(q[0], 10)[9].squared_distance
              + jdb.query(q[0], 11)[10].squared_distance) / 2

    async def mine():
        adb = await ft.load_flat_database_async(
            AsyncLocalFileSystem(tmp_path), f"{root}.binpb", device="cpu")
        return ([await adb.query(v, K) for v in q],
                await adb.query(q[1], K, where=ft.Eq("tenant", "b")),
                await adb.query_range(q[0], radius),
                await adb.query_range(q[0], radius, limit=3,
                                      where=ft.Eq("tenant", "a")),
                await adb.get_attribute(pdb.vector_ids[6], "datum_id"))

    async def theirs():
        adb = await jflat.load_flat_database_async(
            JAsyncLocalFS(tmp_path), f"{root}.binpb")
        return ([await adb.query(v, K) for v in q],
                await adb.query(q[1], K, where=fdb.Eq("tenant", "b")),
                await adb.query_range(q[0], radius),
                await adb.query_range(q[0], radius, limit=3,
                                      where=fdb.Eq("tenant", "a")),
                await adb.get_attribute(jdb.vector_ids[6], "datum_id"))

    got, want = asyncio.run(mine()), asyncio.run(theirs())
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    for g, w in zip(got[1:4], want[1:4]):
        _same(g, w)
    assert got[4] == want[4] == 6
    with pytest.raises(ft.InvalidArgs, match="not attached"):
        got[0][0][0].get_attribute("datum_id")


# -- the golden flat tree --------------------------------------------------------

def _golden_root() -> str:
    return (FIXTURES / "flatgolden_root.txt").read_text().strip()


@pytest.fixture(scope="module")
def golden():
    sdb = ft.load_flat_database(ft.LocalFileSystem(FLATGOLDEN),
                                f"{_golden_root()}.binpb", device="cpu")
    return sdb, np.load(FIXTURES / "flatgolden_query.npy")


def test_flat_golden_decodes_and_answers(golden):
    sdb, q = golden
    assert sdb.metric == "dot" and sdb.num_vectors == 4101
    assert sdb.vector_size == 8
    expected = [line.split(",") for line in
                (FIXTURES / "flatgolden_expected.txt")
                .read_text().splitlines()]
    res = sdb.query(q, k=5)
    assert len(res) == len(expected)
    for r, (vid, vi, dist) in zip(res, expected):
        assert r.vector_id == uuid.UUID(vid)
        assert r.vector_index == int(vi)
        assert r.squared_distance == pytest.approx(float(dist), abs=1e-5)
    ids = [uuid.UUID(int=((k + 1) << 64) | (k + 1)) for k in range(4101)]
    ids[4098] = uuid.UUID(int=0xABCDEF << 64)   # zero lower half
    assert list(sdb._load_chunk(0)[1]) == ids[:4096]
    assert list(sdb._load_chunk(1)[1]) == ids[4096:]
    assert sdb.get_attribute(ids[0], "name") == "zero"
    assert sdb.get_attribute(ids[0], "rank") == 7
    assert sdb.get_attribute(ids[4097], "name") == "tail"
    assert sdb.get_attribute(ids[4100], "rank") == 2 ** 40
    assert sdb.get_attribute(ids[1], "name") is None


def test_flat_golden_resaves_byte_identical_and_async(golden, tmp_path):
    sdb, q = golden
    mat = sdb.to_database()
    assert mat.metric == "dot"
    assert ft.save_flat_database(mat, ft.LocalFileSystem(tmp_path)) == \
        _golden_root()
    assert _files(tmp_path) == _files(FLATGOLDEN)

    async def go():
        adb = await ft.load_flat_database_async(
            AsyncLocalFileSystem(str(FLATGOLDEN)), f"{_golden_root()}.binpb",
            device="cpu")
        return await adb.query(q, k=5)

    assert [r.vector_id for r in asyncio.run(go())] == \
        [r.vector_id for r in sdb.query(q, k=5)]


def test_flat_update_then_resave_writes_only_new_chunks(tmp_path):
    rng = np.random.default_rng(6)
    db = ft.FlatDatabase(rng.standard_normal((4100, 4)).astype(np.float32),
                         seed=3, device="cpu")
    fs = ft.LocalFileSystem(tmp_path)
    root = ft.save_flat_database(db, fs)
    before = _files(tmp_path)
    mem = ft.load_flat_database(fs, f"{root}.binpb", device="cpu") \
        .to_database()
    mem.append(rng.standard_normal((4, 4)).astype(np.float32))
    root2 = ft.save_flat_database(mem, fs)
    after = _files(tmp_path)
    new = set(after) - set(before)
    # the full first chunk is reused; the short tail chunk, its log and
    # the root are new
    assert len(new) == 3 and f"{root2}.binpb" in new


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_exact_topk_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((5000, 64)).astype(np.float32)
    q = rng.standard_normal((33, 64)).astype(np.float32)
    mask = rng.random(5000) < 0.5
    for metric in ("l2", "dot"):
        for m in (None, mask):
            kw = dict(k=10, chunk=1536, metric=metric)
            cpu = exact_topk(torch.from_numpy(q), torch.from_numpy(x),
                             None if m is None else torch.from_numpy(m),
                             **kw)
            card = exact_topk(torch.from_numpy(q).to(cuda),
                              torch.from_numpy(x).to(cuda),
                              None if m is None
                              else torch.from_numpy(m).to(cuda), **kw)
            same_ranked(card[0].cpu().numpy(), card[1].cpu().numpy(),
                        cpu[0].numpy(), cpu[1].numpy())


@pytest.mark.cuda
def test_flat_database_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = _queries(x)
    card = ft.FlatDatabase(x, seed=4, device="cuda")
    cpu = ft.FlatDatabase(x, seed=4, device="cpu")
    for db in (card, cpu):
        for i in range(0, 3000, 4):
            db.set_attribute_at(i, ("tag", i % 3))
    for got, want in zip(card.query_batch(q, K), cpu.query_batch(q, K)):
        _same(got, want)
    assert card._dev.device.type == "cuda"
    for got, want in zip(card.query_batch(q, K, where=ft.Eq("tag", 1)),
                         cpu.query_batch(q, K, where=ft.Eq("tag", 1))):
        _same(got, want)
    root = ft.save_flat_database(card, ft.LocalFileSystem(tmp_path))
    sdb = ft.load_flat_database(ft.LocalFileSystem(tmp_path),
                                f"{root}.binpb", device="cuda")
    sdb.preload()
    assert sdb._dev[0].device.type == "cuda"
    for got, want in zip(sdb.query_batch(q, K), card.query_batch(q, K)):
        assert [(r.vector_id, r.squared_distance) for r in got] == \
            [(r.vector_id, r.squared_distance) for r in want]
