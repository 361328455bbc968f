"""Attribute filters in the PyTorch port (``filters.py``, ``row_mask`` in
``ops.bucketed`` / ``ops.adc`` / ``serving``, ``Database(where=)``)
against the JAX package on identical inputs.

Masks must be equal outright; query results equal up to distance ties,
distances within rel 1e-4, abs 1e-5 (``_torch_helpers``). The card tests
hold K-A's filtered query against the same call on CPU tensors; they
carry the ``cuda`` marker and skip here.
"""

import uuid as _uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from _torch_helpers import cuda, same_ranked, same_results  # noqa: F401
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import filters as jf
from flechasdb_tpu.ops import adc as jadc
from flechasdb_tpu.ops import bucketed as jb
from flechasdb_tpu.serving import DeviceIndex as JaxIndex
from flechasdb_tpu_torch import errors, filters
from flechasdb_tpu_torch.ops import adc, bucketed
from flechasdb_tpu_torch.serving import DeviceIndex


def _table(n, seed):
    """A corpus of ``n`` ids and attributes of mixed str / uint64 values:
    "v" is either type, "w" uint64 (large values too), "s" str; some rows
    hold an empty map, some none."""
    rng = np.random.default_rng(seed)
    ids = [_uuid.UUID(int=int(i) + 1) for i in range(n)]
    table = {}
    for i, vid in enumerate(ids):
        kind = rng.integers(0, 6)
        if kind == 0:
            continue                                    # no attributes
        attrs = {}
        if kind >= 2:
            attrs["v"] = (str(rng.integers(0, 5)) if rng.random() < 0.5
                          else int(rng.integers(0, 5)))
        if kind >= 3:
            attrs["w"] = [0, 3, 7, 2 ** 63, 2 ** 64 - 1][rng.integers(0, 5)]
        if kind >= 4:
            attrs["s"] = ["red", "blue", "", "grün"][rng.integers(0, 4)]
        table[vid] = attrs                              # kind 1: empty
    return ids, table


def _filters(pkg):
    eq, in_, rng_, ex = pkg.Eq, pkg.In, pkg.Range, pkg.Exists
    return [eq("v", 3), eq("v", "3"), eq("w", 2 ** 64 - 1), eq("s", ""),
            eq("missing", 1), in_("v", [1, "1", 4]), in_("s", ("red",)),
            in_("w", [7, 2 ** 63]), rng_("w", lo=3), rng_("w", hi=7),
            rng_("w", lo=1, hi=2 ** 63), rng_("v", hi=2), rng_("s", lo=0),
            ex("s"), ex("missing"),
            eq("v", 2) & ex("w"), eq("s", "red") | rng_("w", lo=2 ** 63),
            ~ex("v"), ~(eq("v", "0") | in_("w", [0])) & ex("s")]


@pytest.mark.parametrize("fi", range(len(_filters(filters))))
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_mask_matches_jax(fi, seed):
    ids, table = _table(400, seed)
    got = filters.evaluate_mask(_filters(filters)[fi], ids, table,
                                filters.ColumnCache())
    want = jf.evaluate_mask(_filters(jf)[fi], ids, table, jf.ColumnCache())
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


def _bad(pkg):
    return [lambda: pkg.Eq("", "x"), lambda: pkg.Eq(3, "x"),
            lambda: pkg.Eq("k", 3.5), lambda: pkg.Eq("k", True),
            lambda: pkg.Eq("k", -1), lambda: pkg.Eq("k", 2 ** 64),
            lambda: pkg.In("k", []), lambda: pkg.In("k", [1, None]),
            lambda: pkg.Range("k"), lambda: pkg.Range("k", lo="a"),
            lambda: pkg.Range("k", lo=False), lambda: pkg.Range("k", lo=-1),
            lambda: pkg.Range("k", hi=2 ** 64), lambda: pkg.Exists(""),
            lambda: pkg.Eq("k", "x") & "not a filter",
            lambda: pkg.Eq("k", "x") | 3,
            lambda: pkg.evaluate_mask("x", [], {}, pkg.ColumnCache())]


@pytest.mark.parametrize("i", range(len(_bad(filters))))
def test_validation_errors_match_jax(i):
    with pytest.raises(errors.InvalidArgs) as got:
        _bad(filters)[i]()
    with pytest.raises(jerrors.InvalidArgs) as want:
        _bad(jf)[i]()
    assert str(got.value) == str(want.value)


def test_filters_are_hashable_and_exported():
    assert hash(ft.Eq("k", "x")) == hash(ft.Eq("k", "x"))
    assert ft.Eq("k", 1) != ft.Eq("k", "1")
    assert hash(ft.In("k", [1, 2])) == hash(ft.In("k", (1, 2)))
    assert hash(ft.Eq("a", 1) & ~ft.Exists("b")) == \
        hash(ft.Eq("a", 1) & ~ft.Exists("b"))
    assert {ft.Range("k", lo=1), ft.Range("k", lo=1)} == {ft.Range("k", lo=1)}
    for name in ("Eq", "Exists", "Filter", "In", "Range"):
        assert getattr(ft, name) is getattr(filters, name)
        assert name in ft.__all__
    assert filters.__all__ == jf.__all__


# --- row_mask in the two scans ----------------------------------------------

def _index(rng, n=700, m=64, p=9, d=4, c=16):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return centroids, codebooks, codes, pidx


def _masks(rng, n):
    return {"sparse": rng.random(n) < 0.05, "half": rng.random(n) < 0.5,
            "none": np.zeros(n, bool), "all": np.ones(n, bool)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _host(ts):
    return [np.asarray(t) for t in ts]


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("which", ["sparse", "half", "none", "all"])
@pytest.mark.parametrize("nprobe,k", [(3, 10), (9, 400)])
def test_query_bucketed_row_mask_matches_jax(metric, which, nprobe, k):
    rng = np.random.default_rng(nprobe + k)
    centroids, codebooks, codes, pidx = _index(rng)
    q = rng.standard_normal((6, 64)).astype(np.float32)
    mask = _masks(rng, len(codes))[which]
    got = _host(bucketed.query_bucketed(
        _t(q), _t(centroids), _t(codebooks),
        bucketed.bucketize(codes, pidx, 9), _t(mask), k=k, nprobe=nprobe,
        metric=metric))
    want = _host(jb.query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jb.bucketize(codes, pidx, 9, pack="auto"), None, jnp.asarray(mask),
        k=k, nprobe=nprobe, impl="gather", metric=metric))
    np.testing.assert_array_equal(got[2], want[2])
    same_ranked(got[0], got[1], want[0], want[1])
    fin = np.isfinite(got[0])
    assert mask[got[1][fin]].all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("which", ["sparse", "half", "none"])
def test_query_masked_scan_row_mask_matches_jax(metric, which):
    rng = np.random.default_rng(21)
    centroids, codebooks, codes, pidx = _index(rng)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    mask = _masks(rng, len(codes))[which]
    got = _host(adc.query_masked_scan(
        _t(q), _t(centroids), _t(codebooks), _t(codes), _t(pidx), _t(mask),
        k=30, nprobe=4, metric=metric))
    want = _host(jadc.query_masked_scan(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(codes), jnp.asarray(pidx), None, jnp.asarray(mask),
        k=30, nprobe=4, metric=metric))
    np.testing.assert_array_equal(got[2], want[2])
    same_ranked(got[0], got[1], want[0], want[1])


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_layouts_agree_under_one_mask(metric):
    """The bucketed and the masked DeviceIndex give the same filtered
    results, with and without rerank, and so does the JAX package's."""
    rng = np.random.default_rng(22)
    centroids, codebooks, codes, pidx = _index(rng, n=800, p=8)
    q = rng.standard_normal((6, 64)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((800, 64)).astype(np.float32))
    mask = rng.random(800) < 0.3
    out = {}
    for layout in ("bucketed", "masked"):
        index = DeviceIndex(centroids, codebooks, codes, pidx, layout=layout,
                            metric=metric, device="cpu")
        jindex = JaxIndex(centroids, codebooks, codes, pidx, layout=layout,
                          metric=metric)
        out[layout] = index.query(q, 12, 8, row_mask=mask)
        want = jindex.query(q, 12, 8, row_mask=mask)
        same_ranked(out[layout][0], out[layout][1], want[0], want[1])
        out[layout + "_rr"] = index.query_rerank(
            q, x, 5, 8, 40, row_mask=torch.from_numpy(mask))
    same_ranked(*out["bucketed"][:2], *out["masked"][:2])
    same_ranked(*out["bucketed_rr"], *out["masked_rr"])
    assert mask[out["bucketed_rr"][1]].all()


def test_row_mask_of_the_wrong_length_is_refused():
    rng = np.random.default_rng(23)
    index = DeviceIndex(*_index(rng), device="cpu")
    q = rng.standard_normal((2, 64)).astype(np.float32)
    with pytest.raises(ValueError, match=r"row_mask shape \(699,\) != "
                                         r"\(700,\)"):
        index.query(q, 5, 2, row_mask=np.ones(699, bool))


# --- Database(where=) -------------------------------------------------------

@pytest.fixture(scope="module", params=["l2", "dot", "cosine"])
def filtered_dbs(request):
    """The JAX package's database and the port's copy of it, with the same
    attributes set through each one's ``set_attribute_at``."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    jdb = (fdb.DatabaseBuilder(x).with_partitions(8).with_divisions(4)
           .with_clusters(16).with_seed(5).with_metric(request.param)
           .build())
    db = ft.from_jax_arrays(jdb, device="cpu")
    db.attribute_table = {}
    for i in range(600):
        for d in (db, jdb):
            d.set_attribute_at(i, ("parity", "even" if i % 2 == 0
                                   else "odd"))
            d.set_attribute_at(i, ("idx", i))
    return db, jdb, x


def _where(pkg):
    return [pkg.Eq("parity", "even"), pkg.Range("idx", lo=100, hi=299),
            pkg.In("parity", ["odd"]) & pkg.Range("idx", hi=150),
            ~pkg.Exists("idx")]


@pytest.mark.parametrize("fi", range(4))
@pytest.mark.parametrize("rerank", [None, 25])
def test_database_where_matches_jax(filtered_dbs, fi, rerank):
    db, jdb, x = filtered_dbs
    where, jwhere = _where(ft)[fi], _where(fdb)[fi]
    q = x[:5] + 0.1
    got = db.query_batch(q, k=5, nprobe=4, rerank=rerank, where=where)
    want = jdb.query_batch(q, k=5, nprobe=4, rerank=rerank, where=jwhere)
    mask = db._filter_mask(where)
    row = {vid: i for i, vid in enumerate(db.vector_ids)}
    for g, w in zip(got, want):
        same_results(g, w)
        assert all(mask[row[r.vector_id]] for r in g)
    same_results(db.query(q[0], 7, 8, where=where),
                 jdb.query(q[0], 7, 8, where=jwhere))


def test_filter_that_matches_nothing_gives_empty_results(filtered_dbs):
    db, jdb, x = filtered_dbs
    nothing = ft.Eq("parity", "nope")
    assert db.query(x[0], k=5, nprobe=8, where=nothing) == []
    assert db.query_batch(x[:3], 5, 8, where=nothing) == [[], [], []]
    assert db.query_batch(x[:3], 5, 8, rerank=20, where=nothing) == \
        [[], [], []]
    assert jdb.query(x[0], k=5, nprobe=8, where=fdb.Eq("parity", "nope")) \
        == []


def test_set_attribute_at_invalidates_the_filter_cache(filtered_dbs):
    db, jdb, x = filtered_dbs
    q = x[5]
    assert db.query(q, k=3, nprobe=8, where=ft.Eq("tag", "hot")) == []
    db.set_attribute_at(5, ("tag", "hot"))
    jdb.set_attribute_at(5, ("tag", "hot"))
    after = db.query(q, k=3, nprobe=8, where=ft.Eq("tag", "hot"))
    assert [r.vector_id for r in after] == [db.vector_ids[5]]
    same_results(after, jdb.query(q, k=3, nprobe=8,
                                  where=fdb.Eq("tag", "hot")))
    for d in (db, jdb):
        d.attribute_table[d.vector_ids[5]].pop("tag")
        d._invalidate_filters()


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_filtered_query_bucketed_on_card(cuda, metric):
    """K-A's filtered query against the same call on CPU tensors; the last
    partition holds no row, so with every partition probed some cells
    reach K-A with length 0."""
    rng = np.random.default_rng(24)
    centroids, codebooks, codes, pidx = _index(rng, n=3000, m=96, p=10,
                                               d=12, c=64)
    pidx[pidx == 9] = 0
    q = rng.standard_normal((16, 96)).astype(np.float32)
    mask = rng.random(3000) < 0.2
    bk = bucketed.bucketize(codes, pidx, 10)
    assert int(bk.lengths[9]) == 0
    out = {}
    for dev in ("cpu", cuda):
        got = bucketed.query_bucketed(
            _t(q).to(dev), _t(centroids).to(dev), _t(codebooks).to(dev),
            bucketed.Buckets(*(t.to(dev) for t in bk)), _t(mask).to(dev),
            k=20, nprobe=10, metric=metric)
        out[str(dev)] = [t.cpu().numpy() for t in got]
    card, cpu = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(card[2], cpu[2])
    same_ranked(card[0], card[1], cpu[0], cpu[1])
    assert mask[card[1][np.isfinite(card[0])]].all()
