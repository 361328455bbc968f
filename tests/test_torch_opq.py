"""OPQ in the PyTorch port (``flechasdb_tpu_torch.ops.opq``, the rotation
in the tables, ``encode``, ``DeviceIndex``, the builder, ``convert`` and
the stored tier) against the JAX package, on ``tests/test_opq.py``'s
``correlated`` data (covariance across division boundaries).

Tolerances:

* the rotation orthogonal within 1e-4 (``tests/test_opq.py:27``);
  distances kept within rel 1e-4;
* OPQ's quantization error below 0.9 times plain PQ's, as in the JAX
  test; the port's ``quantization_error`` within rel 1e-5 of the JAX
  function's on the same arrays (both f32);
* a JAX OPQ database carried across by ``convert.from_jax_arrays``
  answers ``query``, ``query_batch``, ``query_range`` and ``where=`` as
  the JAX package does: rows up to distance ties, distances within rel
  1e-4, abs 1e-5 (``tests/_torch_helpers``); range radii halfway between
  two distinct keys;
* ``encode`` with a rotation and ``add_vectors`` give the JAX package's
  codes exactly (both assign with full-f32 products on this data), and
  the saved tree is byte-identical.

Fits draw different random numbers in the two packages, so the port's
own OPQ builds are held to the JAX test's quality bounds, not to bits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from _torch_helpers import midpoint_radius, same_range, same_ranked, \
    same_results
from flechasdb_tpu.ops import opq as jopq
from flechasdb_tpu.ops.encode import encode as jencode
from flechasdb_tpu.serving import DeviceIndex as JaxIndex
from flechasdb_tpu_torch.ops import kmeans, opq
from flechasdb_tpu_torch.ops.encode import encode
from flechasdb_tpu_torch.serving import DeviceIndex


@pytest.fixture(scope="module")
def correlated():
    """``tests/test_opq.py``'s data, made the same way."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((6, 48)).astype(np.float32)
    z = rng.standard_normal((4000, 6)).astype(np.float32)
    return (z @ w + 0.02 * rng.standard_normal((4000, 48))).astype(
        np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- ops.opq -----------------------------------------------------------------

def test_rotation_is_orthogonal(correlated):
    res = opq.fit_opq(torch.from_numpy(correlated), 8, 32, _gen(0), iters=4,
                      inner_rounds=10, final_rounds=25)
    r = res.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(48), atol=1e-4)


def test_opq_reduces_quantization_error(correlated):
    x = torch.from_numpy(correlated)
    d, c = 8, 32
    divided = x.reshape(len(x), d, -1).transpose(0, 1).contiguous()
    pq0 = kmeans.fit(divided, c, _gen(0), max_rounds=25)
    base = opq.quantization_error(x, torch.eye(48), pq0, d=d)
    res = opq.fit_opq(x, d, c, _gen(0), iters=4, inner_rounds=10,
                      final_rounds=25)
    got = opq.quantization_error(x, res.rotation, res.pq, d=d)
    assert got < base * 0.9, (got, base)


def test_rotation_preserves_distances(correlated):
    res = opq.fit_opq(torch.from_numpy(correlated[:500]), 8, 16, _gen(1),
                      iters=2, inner_rounds=5, final_rounds=10)
    r = res.rotation.numpy()
    a, b = correlated[0], correlated[1]
    assert (((a - b) @ r) ** 2).sum() == pytest.approx(((a - b) ** 2).sum(),
                                                       rel=1e-4)


def test_quantization_error_and_parts_match_jax(correlated):
    """On the JAX fit's own rotation and codebooks: the reconstruction
    equal, the Gram and the error within f32 rounding."""
    x = correlated[:1500]
    jres = jopq.fit_opq(jnp.asarray(x), 8, 16, jax.random.key(2), iters=2,
                        inner_rounds=5, final_rounds=10)
    want = jopq.quantization_error(jnp.asarray(x), jres.rotation, jres.pq,
                                   d=8)
    pq = kmeans.KMeansResult(*(torch.from_numpy(np.array(a))
                               for a in jres.pq))
    rot = torch.from_numpy(np.array(jres.rotation))
    got = opq.quantization_error(torch.from_numpy(x), rot, pq, d=8)
    assert got == pytest.approx(want, rel=1e-5)
    yhat = opq._reconstruct(pq.centroids, pq.indices)
    np.testing.assert_array_equal(
        yhat.numpy(), np.asarray(jopq._reconstruct(
            jres.pq.centroids, jres.pq.indices, d=8)))
    np.testing.assert_allclose(
        opq._gram(torch.from_numpy(x), yhat).numpy(),
        np.asarray(jopq._gram(jnp.asarray(x), jnp.asarray(yhat.numpy()))),
        rtol=1e-4, atol=1e-3)


def test_fit_opq_seeding_rule_and_times(correlated):
    """The same int seed gives the same fit; a generator gives the fit of
    its first draw and advances; each iteration has its own generator;
    ``times`` gets every part."""
    x = torch.from_numpy(correlated[:600])
    kw = dict(iters=2, inner_rounds=3, final_rounds=4)
    a = opq.fit_opq(x, 8, 8, 123, **kw)
    times = {}
    b = opq.fit_opq(x, 8, 8, 123, times=times, **kw)
    assert torch.equal(a.rotation, b.rotation)
    assert torch.equal(a.pq.indices, b.pq.indices)
    assert set(times) == {"pq_fits", "rotations", "reconstructions", "gram",
                          "svd"}
    assert all(v >= 0 for v in times.values())
    gen = _gen(5)
    seed = int(torch.randint(0, 2**62, (1,), generator=_gen(5)))
    c = opq.fit_opq(x, 8, 8, gen, **kw)
    assert torch.equal(c.rotation, opq.fit_opq(x, 8, 8, seed, **kw).rotation)
    draws = [opq._fold_in(seed, it, torch.device("cpu")).initial_seed()
             for it in range(3)]
    assert len(set(draws)) == 3
    assert draws == [opq._fold_in(seed, it, torch.device("cpu"))
                     .initial_seed() for it in range(3)]


# --- a JAX OPQ database carried across ---------------------------------------

N_DB, P, D, C = 1500, 8, 8, 16


@pytest.fixture(scope="module", params=["l2", "dot", "cosine"])
def carried(request, correlated):
    """The JAX package's OPQ database (tenant on every row) and the port's
    copy of its arrays."""
    x = correlated[:N_DB]
    jdb = (fdb.DatabaseBuilder(x).with_partitions(P).with_divisions(D)
           .with_clusters(C).with_seed(7).with_metric(request.param)
           .with_opq(2).build())
    for i in range(N_DB):
        jdb.set_attribute_at(i, ("tenant", i % 3))
    mine = ft.from_jax_arrays(jdb, device="cpu")
    return request.param, x, jdb, mine


def _queries(x, n=6, seed=8):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    return (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)


def test_carried_database_has_the_rotation(carried):
    _, _, jdb, mine = carried
    assert mine.rotation.dtype == np.float32
    np.testing.assert_array_equal(mine.rotation, np.asarray(jdb.rotation))
    back = ft.to_arrays(mine)
    np.testing.assert_array_equal(back["rotation"], mine.rotation)
    np.testing.assert_array_equal(fdb.Database(**back).rotation,
                                  mine.rotation)


def test_carried_database_queries_the_same(carried):
    _, x, jdb, mine = carried
    q = _queries(x)
    for v in q:
        same_results(mine.query(v, k=10, nprobe=3),
                     jdb.query(v, k=10, nprobe=3))
    for got, want in zip(mine.query_batch(q, k=10, nprobe=3),
                         jdb.query_batch(q, k=10, nprobe=3)):
        same_results(got, want)
    where_m, where_j = ft.Eq("tenant", 1), fdb.Eq("tenant", 1)
    for v in q[:3]:
        same_results(mine.query(v, k=10, nprobe=3, where=where_m),
                     jdb.query(v, k=10, nprobe=3, where=where_j))
    for got, want in zip(mine.query_batch(q, 10, 3, where=where_m),
                         jdb.query_batch(q, 10, 3, where=where_j)):
        same_results(got, want)


def test_carried_database_query_range_the_same(carried):
    _, x, jdb, mine = carried
    q = _queries(x, n=3, seed=9)
    row_of = {vid: i for i, vid in enumerate(mine.vector_ids)}

    def hits(results):
        return (np.array([row_of[r.vector_id] for r in results], np.int64),
                np.array([r.squared_distance for r in results], np.float32))

    for v in q:
        keys = [r.squared_distance for r in jdb.query(v, k=40, nprobe=3)]
        radius = midpoint_radius(np.asarray(keys), 0.5)
        for kw_m, kw_j in (({}, {}),
                           ({"where": ft.Eq("tenant", 2)},
                            {"where": fdb.Eq("tenant", 2)})):
            same_range([hits(mine.query_range(v, radius, 3, **kw_m))],
                       [hits(jdb.query_range(v, radius, 3, **kw_j))])


@pytest.mark.parametrize("layout", ["bucketed", "masked"])
def test_device_index_with_rotation_matches_jax(carried, layout):
    metric, x, jdb, _ = carried
    arrays = (jdb.partition_centroids, jdb.codebooks,
              np.asarray(jdb.codes, np.int32), jdb.partition_indices)
    kw = dict(layout=layout, rotation=jdb.rotation,
              metric="dot" if metric == "dot" else "l2")
    mine = DeviceIndex(*arrays, device="cpu", **kw)
    ref = JaxIndex(*arrays, **kw)
    q = _queries(x)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.arange(N_DB) % 3 != 0
    for row_mask in (None, mask):
        gd, gr, gp = mine.query(q, 10, 3, row_mask=row_mask)
        wd, wr, wp = ref.query(q, 10, 3, row_mask=row_mask)
        np.testing.assert_array_equal(gp, wp)
        same_ranked(gd, gr, wd, wr)
    radius = midpoint_radius(np.asarray(wd), 0.5)
    same_range(mine.query_range(q, radius, 3),
               ref.query_range(q, radius, 3))


def test_encode_with_rotation_matches_jax(carried):
    _, x, jdb, _ = carried
    new = _queries(x, n=40, seed=3)
    args = (jdb.partition_centroids, jdb.codebooks, jdb.rotation)
    got = encode(torch.from_numpy(new),
                 *(torch.from_numpy(np.array(a)) for a in args))
    want = jencode(jnp.asarray(new), *(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    plain = encode(torch.from_numpy(new),
                   *(torch.from_numpy(np.array(a)) for a in args[:2]))
    assert not np.array_equal(plain[1].numpy(), got[1].numpy())


def test_add_vectors_on_an_opq_database_matches_jax(correlated):
    x = correlated[:N_DB]
    jdb = (fdb.DatabaseBuilder(x).with_partitions(P).with_divisions(D)
           .with_clusters(C).with_seed(7).with_opq(2).build())
    mine = ft.from_jax_arrays(jdb, device="cpu")
    new = correlated[N_DB:N_DB + 50]
    ids = mine.add_vectors(new, seed=4)
    assert ids == jdb.add_vectors(new, seed=4)
    np.testing.assert_array_equal(mine.partition_indices,
                                  np.asarray(jdb.partition_indices))
    np.testing.assert_array_equal(mine.codes, np.asarray(jdb.codes))
    for i, v in enumerate(new[:5]):
        got = mine.query(v, k=5, nprobe=P)
        same_results(got, jdb.query(v, k=5, nprobe=P))
        assert got[0].vector_id == ids[i]


def test_opq_tree_is_byte_identical_and_serves(carried, tmp_path):
    """The same arrays save to the same tree (``rotations/`` included);
    loaded by the port, cold queries equal the in-memory ones, and so do
    queries after ``preload``, and ``to_database`` carries the rotation."""
    metric, x, jdb, mine = carried
    root = ft.save_database(mine, ft.LocalFileSystem(tmp_path / "port"))
    jroot = fdb.save_database(jdb, fdb.LocalFileSystem(tmp_path / "jax"))
    assert root == jroot

    def files(base):
        return {os.path.relpath(os.path.join(d, f), base):
                open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(base) for f in fs}

    tree = files(tmp_path / "port")
    assert tree == files(tmp_path / "jax")
    assert any(name.startswith("rotations") for name in tree)
    sdb = ft.load_database(ft.LocalFileSystem(tmp_path / "port"),
                           f"{root}.binpb", device="cpu")
    q = _queries(x, n=3)
    want = [mine.query(v, k=5, nprobe=3) for v in q]
    for v, w in zip(q, want):
        same_results(sdb.query(v, k=5, nprobe=3), w)
    np.testing.assert_array_equal(sdb.to_database().rotation, mine.rotation)
    sdb.preload()
    assert sdb._dev[0].rotation is not None
    for got, w in zip(sdb.query_batch(q, k=5, nprobe=3), want):
        same_results(got, w)


# --- the port's own OPQ build -------------------------------------------------

def test_port_opq_build_end_to_end(correlated, tmp_path):
    """``tests/test_opq.py``'s end-to-end case on the port: recall of the
    OPQ database at least the plain one's less 0.02; the rotation saved,
    loaded, queried cold and after ``preload`` as in memory; events as the
    JAX package's (no cluster events inside OPQ)."""
    x = correlated
    q = x[:50]
    d_exact = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d_exact, axis=1, kind="stable")[:, :10]

    def recall(db):
        row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
        res = db.query_batch(q, k=10, nprobe=8)
        return np.mean([len({row_of[r.vector_id] for r in rs}
                            & set(gt[b].tolist())) / 10
                        for b, rs in enumerate(res)])

    def builder(pkg, **kw):
        return (pkg.DatabaseBuilder(x, **kw).with_partitions(8)
                .with_divisions(8).with_clusters(32).with_seed(7))

    plain = builder(ft, device="cpu").build()
    seen, jseen = [], []
    opq_db = builder(ft, device="cpu").with_opq(4).build_with_events(
        seen.append)
    builder(fdb).with_opq(1).build_with_events(jseen.append)

    def top(events):              # the coarse fit's cluster events aside
        return [type(e).__name__ for e in events
                if type(e).__name__ != "ClusterEvent"]

    assert top(seen) == top(jseen)
    names = [type(e).__name__ for e in seen]
    first = names.index("StartingQuantization")
    assert "ClusterEvent" not in names[first:]
    assert opq_db.rotation is not None and opq_db.rotation.shape == (48, 48)
    assert recall(opq_db) >= recall(plain) - 0.02
    root = ft.save_database(opq_db, ft.LocalFileSystem(tmp_path))
    sdb = ft.load_database(ft.LocalFileSystem(tmp_path), f"{root}.binpb",
                           device="cpu")
    want = opq_db.query(x[10], k=5, nprobe=8)
    assert [r.vector_id for r in sdb.query(x[10], k=5, nprobe=8)] == \
        [r.vector_id for r in want]
    sdb.preload()
    assert [r.vector_id for r in sdb.query(x[10], k=5, nprobe=8)] == \
        [r.vector_id for r in want]


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_opq_on_card_matches_the_cpu_path(correlated):
    """A card OPQ build (TF32 allowed in the process: every rotation
    product must still run in full f32) answers as the same arrays on
    the CPU, through K-A on the rotated tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flechasdb_tpu_torch import _kernels
    # The global API, as tests/test_torch_query.py's tf32_on fixture sets
    # it: it keeps PyTorch's legacy and per-backend settings in step.
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        x = correlated
        _kernels.reset_launches()
        db = (ft.DatabaseBuilder(x, device="cuda").with_partitions(8)
              .with_divisions(8).with_clusters(32).with_seed(7).with_opq(3)
              .build())
        assert _kernels.LAUNCHES["lloyd_round"] > 0
        np.testing.assert_allclose(db.rotation @ db.rotation.T, np.eye(48),
                                   atol=1e-4)
        ref = ft.Database(**ft.to_arrays(db), device="cpu")
        q = _queries(x, n=16)
        for g, w in zip(db.query_batch(q, k=10, nprobe=4),
                        ref.query_batch(q, k=10, nprobe=4)):
            same_results(g, w)
        arrays = (db.partition_centroids, db.codebooks,
                  db.codes.astype(np.int32), db.partition_indices)
        index = DeviceIndex(*arrays, layout="bucketed", rotation=db.rotation,
                            device="cuda")
        cpu = DeviceIndex(*arrays, layout="bucketed", rotation=db.rotation,
                          device="cpu")
        before = _kernels.LAUNCHES["adc_scan"]
        gd, gr, gp = index.query(q, 10, 4)
        assert _kernels.LAUNCHES["adc_scan"] == before + 1
        wd, wr, wp = cpu.query(q, 10, 4)
        np.testing.assert_array_equal(gp, wp)
        same_ranked(gd, gr, wd, wr)
    finally:
        torch.set_float32_matmul_precision(prev)
