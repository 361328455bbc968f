"""Range search in the PyTorch port (``ops.bucketed.range_bucketed``,
``ops.adc.range_masked_scan``, ``serving.DeviceIndex.query_range``,
``Database.query_range``) against the JAX package on identical inputs.

Every radius lies halfway between two consecutive distinct keys
(``_torch_helpers.midpoint_radius``): the two packages' keys differ in
their last bits, so a radius at a key could take a row in one and not in
the other. Results must hold the same rows, in the same order up to
distance ties, keys within rel 1e-4, abs 1e-5. The card test holds K-A's
range scan against the same call on CPU tensors; it carries the ``cuda``
marker and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from _torch_helpers import (cuda, midpoint_radius, same_range,  # noqa: F401
                            same_results, RTOL, ATOL)
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import serving as jserving
from flechasdb_tpu import stored as jstored
from flechasdb_tpu.ops import adc as jadc
from flechasdb_tpu.ops import bucketed as jb
from flechasdb_tpu_torch import errors, host, serving
from flechasdb_tpu_torch.ops import adc, bucketed
from flechasdb_tpu_torch.serving import DeviceIndex


def _index(rng, n=900, m=64, p=12, d=4, c=64):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return centroids, codebooks, codes, pidx


def _t(a):
    return torch.from_numpy(np.array(a))


def _host(ts):
    return [np.asarray(t) for t in ts]


def _keys_match(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nprobe", [1, 5, 12])
def test_range_bucketed_matches_jax(metric, masked, nprobe):
    rng = np.random.default_rng(nprobe)
    centroids, codebooks, codes, pidx = _index(rng)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    mask = rng.random(len(codes)) < 0.4 if masked else None
    got = _host(bucketed.range_bucketed(
        _t(q), _t(centroids), _t(codebooks),
        bucketed.bucketize(codes, pidx, 12),
        None if mask is None else _t(mask), nprobe=nprobe, metric=metric))
    want = _host(jb.range_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jb.bucketize(codes, pidx, 12, pack="auto"), None,
        None if mask is None else jnp.asarray(mask), nprobe=nprobe,
        impl="gather", metric=metric))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[2], want[2])          # probed
    np.testing.assert_array_equal(got[1], want[1])          # rows, -1 pads
    _keys_match(got[0], want[0])
    np.testing.assert_array_equal(got[1] < 0, np.isinf(got[0]))


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
def test_range_masked_scan_matches_jax(metric, masked):
    rng = np.random.default_rng(30)
    centroids, codebooks, codes, pidx = _index(rng)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    mask = rng.random(len(codes)) < 0.4 if masked else None
    got = _host(adc.range_masked_scan(
        _t(q), _t(centroids), _t(codebooks), _t(codes), _t(pidx),
        None if mask is None else _t(mask), nprobe=4, metric=metric))
    want = _host(jadc.range_masked_scan(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(codes), jnp.asarray(pidx), None,
        None if mask is None else jnp.asarray(mask), nprobe=4,
        metric=metric))
    np.testing.assert_array_equal(got[1], want[1])
    _keys_match(got[0], want[0])


def _chunking_budget(layout, index, nprobe):
    """A budget that lets two queries through at a time."""
    d, c, _ = index.codebooks.shape
    if layout == "bucketed":
        per = 4 * nprobe * (d * c + 4 * index.buckets.codes.shape[2])
        return 2 * per
    p, m = index.centroids.shape
    n = index.num_rows
    per = 16 * n
    if index.metric != "dot":
        per = max(per, 8 * (p * d * c + p * m), 4 * p * d * c + 8 * n)
    return 16 * n + 2 * per


@pytest.mark.parametrize("layout", ["bucketed", "masked"])
@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("chunked", [False, True])
def test_device_index_query_range_matches_jax(layout, metric, chunked):
    rng = np.random.default_rng(31)
    arrays = _index(rng)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    mask = rng.random(900) < 0.5 if metric == "dot" else None
    nprobe = 4
    jindex = jserving.DeviceIndex(*arrays, layout=layout, metric=metric)
    every = jindex.query_range(q, 3e38, nprobe, row_mask=mask)
    radius = midpoint_radius(np.concatenate([k for _, k in every]), 0.2)
    index = DeviceIndex(*arrays, layout=layout, metric=metric, device="cpu")
    if chunked:
        index.hbm_budget_bytes = _chunking_budget(layout, index, nprobe)
        limit = (serving._range_limit(nprobe, index.buckets.codes.shape[2],
                                      tuple(index.codebooks.shape),
                                      index.hbm_budget_bytes)
                 if layout == "bucketed" else index._masked_batch_limit())
        assert limit == 2
    got = index.query_range(q, radius, nprobe, row_mask=mask)
    want = jindex.query_range(q, radius, nprobe, row_mask=mask)
    assert sum(len(r) for r, _ in want) > 20
    same_range(got, want)
    for (rows, keys), (_, all_keys) in zip(got, every):
        assert (keys <= radius).all()
        assert len(rows) == int((all_keys <= radius).sum())
        if mask is not None:
            assert mask[rows].all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_range_layouts_agree_row_for_row(metric):
    """Both layouts return the same range set in the same order (ties
    aside), as the JAX package's ``tests/test_range.py`` asks of its own
    layouts."""
    rng = np.random.default_rng(32)
    arrays = _index(rng, n=1500, p=8)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    bk = DeviceIndex(*arrays, layout="bucketed", metric=metric,
                     device="cpu")
    every = bk.query_range(q, 3e38, 5)
    radius = midpoint_radius(np.concatenate([k for _, k in every]), 0.1)
    masked = DeviceIndex(*arrays, layout="masked", metric=metric,
                         device="cpu")
    same_range(bk.query_range(q, radius, 5), masked.query_range(q, radius, 5))


def test_range_limit_and_host_tail_match_jax():
    for args in [(10, 5120, (8, 256, 16), 2 << 30),
                 (5, 1152, (12, 256, 128), 2 << 30), (3, 128, (4, 16, 4), 1)]:
        assert serving._range_limit(*args) == jserving._range_limit(*args)
    assert serving._range_limit(10, 5120, (8, 256, 16), 2 << 30) == 2383
    rng = np.random.default_rng(33)
    keys = rng.standard_normal((3, 50)).astype(np.float32)
    keys[0, :5] = 0.25                       # exact ties keep their order
    keys[1, ::3] = np.inf
    rows = rng.integers(0, 1000, (3, 50)).astype(np.int32)
    got = serving._range_host_tail(keys, rows, 0.25)
    want = jserving._range_host_tail(keys, rows, 0.25)
    for (gr, gk), (wr, wk) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gk, wk)
        assert gr.dtype == wr.dtype == np.int64


# --- Database.query_range ----------------------------------------------------

@pytest.fixture(scope="module", params=["l2", "dot", "cosine"])
def range_dbs(request):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1500, 32), dtype=np.float32)
    q = x[100] + 0.05 * rng.standard_normal(32).astype(np.float32)
    jdb = (fdb.DatabaseBuilder(x).with_partitions(8).with_divisions(4)
           .with_clusters(16).with_seed(1).with_metric(request.param)
           .build())
    db = ft.from_jax_arrays(jdb, device="cpu")
    db.attribute_table = {}
    for i in range(0, 1500, 3):
        db.set_attribute_at(i, ("mod3", 0))
        jdb.set_attribute_at(i, ("mod3", 0))
    every = jdb.query_range(q, 3e38, nprobe=8)
    return db, jdb, q, [r.squared_distance for r in every]


@pytest.mark.parametrize("limit", [None, 3, 10_000])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("nprobe,frac", [(8, 0.02), (8, 0.15), (2, 0.3)])
def test_database_query_range_matches_jax(range_dbs, limit, filtered,
                                          nprobe, frac):
    db, jdb, q, every = range_dbs
    radius = midpoint_radius(every, frac)
    where = ft.Eq("mod3", 0) if filtered else None
    jwhere = fdb.Eq("mod3", 0) if filtered else None
    got = db.query_range(q, radius, nprobe, limit=limit, where=where)
    want = jdb.query_range(q, radius, nprobe, limit=limit, where=jwhere)
    assert want
    same_results(got, want)
    assert all(r.squared_distance <= radius for r in got)
    if limit is not None:
        assert len(got) <= limit
    if filtered:
        row = {vid: i for i, vid in enumerate(db.vector_ids)}
        assert all(row[r.vector_id] % 3 == 0 for r in got)
    assert len({r.partition_index for r in got}) <= nprobe


def test_query_range_matches_the_top_k_under_the_radius(range_dbs):
    """The nearest ``limit`` in range are the top-k whose key is within
    the radius."""
    db, _, q, every = range_dbs
    radius = midpoint_radius(every, 0.01)
    top = [r for r in db.query(q, k=10, nprobe=8)
           if r.squared_distance <= radius]
    same_results(db.query_range(q, radius, 8, limit=10), top)


def _range_errors(pkg_db, q):
    return [lambda: pkg_db.query_range(q, np.inf, nprobe=2),
            lambda: pkg_db.query_range(q, float("nan"), nprobe=2),
            lambda: pkg_db.query_range(q, 1.0, nprobe=0),
            lambda: pkg_db.query_range(q, 1.0, nprobe=999),
            lambda: pkg_db.query_range(q[:5], 1.0, nprobe=2)]


def test_check_range_args_errors_match_jax(range_dbs):
    db, jdb, q, _ = range_dbs
    cases = [(np.inf, 2, 8), (-np.inf, 2, 8), (float("nan"), 1, 8),
             (1.0, 0, 8), (1.0, -3, 8), (1.0, 9, 8), (0.5, 8, 8)]
    for args in cases:
        try:
            jstored.check_range_args(*args)
        except jerrors.InvalidArgs as want:
            with pytest.raises(errors.InvalidArgs) as got:
                host.check_range_args(*args)
            assert str(got.value) == str(want)
        else:
            host.check_range_args(*args)
    for mine, ref in zip(_range_errors(db, q), _range_errors(jdb, q)):
        with pytest.raises(errors.InvalidArgs) as got:
            mine()
        with pytest.raises(jerrors.InvalidArgs) as want:
            ref()
        assert str(got.value) == str(want.value)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
def test_range_bucketed_on_card(cuda, metric, masked):
    """K-A's range scan against the same call on CPU tensors; the last
    partition holds no row, so with every partition probed some cells
    reach K-A with length 0 and must come back ``+inf``, row -1."""
    rng = np.random.default_rng(34)
    centroids, codebooks, codes, pidx = _index(rng, n=3000, m=96, p=10,
                                               d=12, c=256)
    pidx[pidx == 9] = 1
    q = rng.standard_normal((16, 96)).astype(np.float32)
    mask = rng.random(3000) < 0.3 if masked else None
    bk = bucketed.bucketize(codes, pidx, 10)
    assert int(bk.lengths[9]) == 0
    out = {}
    for dev in ("cpu", cuda):
        got = bucketed.range_bucketed(
            _t(q).to(dev), _t(centroids).to(dev), _t(codebooks).to(dev),
            bucketed.Buckets(*(t.to(dev) for t in bk)),
            None if mask is None else _t(mask).to(dev), nprobe=10,
            metric=metric)
        out[str(dev)] = [t.cpu().numpy() for t in got]
    card, cpu = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(card[2], cpu[2])
    np.testing.assert_array_equal(card[1], cpu[1])
    _keys_match(card[0], cpu[0])
    l = bk.codes.shape[2]
    empty = card[2] == 9                                    # [B, nprobe]
    slots = np.repeat(empty, l, axis=1)
    assert slots.any() and np.isinf(card[0][slots]).all()
    assert (card[1][slots] == -1).all()
