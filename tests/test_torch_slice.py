"""The PyTorch port's build → query slice as a whole, against the JAX
package.

* A database the JAX package built, carried across by
  ``from_jax_arrays``, answers ``query``/``query_batch`` with the same
  rows; distances within rel 1e-4, abs 1e-5 (``tests/test_stored.py``'s
  bound).
* A port build clears ``tests/test_recall.py``'s floors, and a port fit
  comes within 2% of the JAX fit's inertia: the two packages draw
  different random numbers, so builds agree in quality, not in bits.
* The same seed gives the same ids; the builder emits the same top-level
  events and raises the same ``InvalidArgs`` cases; a port-built database
  saves and loads with the JAX package.
* The port imports neither jax nor the JAX package, and its copies of the
  jax-free host helpers behave as the originals.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import events as jevents
from flechasdb_tpu import metrics as jmetrics
from flechasdb_tpu import serving as jserving
from flechasdb_tpu import vector as jvector
from flechasdb_tpu.ops import kmeans as jkmeans
from flechasdb_tpu_torch import errors, events, host
from flechasdb_tpu_torch.ops import kmeans

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _builder(pkg, x, p, d, c, seed, metric="l2", **kw):
    return (pkg.DatabaseBuilder(x, **kw).with_partitions(p)
            .with_divisions(d).with_clusters(c).with_seed(seed)
            .with_metric(metric))


def _same_results(got, want):
    assert [r.vector_id for r in got] == [r.vector_id for r in want]
    for g, w in zip(got, want):
        assert g.partition_index == w.partition_index
        assert g.vector_index == w.vector_index
        assert g.squared_distance == pytest.approx(w.squared_distance,
                                                   rel=RTOL, abs=ATOL)


# (n, m, p, d, c, k, nprobe, clusters_in_data, dup, metric): the shapes of
# test_stored.py's differential fuzz that keep the bucketed layout.
_CONFIGS = [(400, 16, 8, 4, 8, 5, 3, None, True, "l2"),
            (600, 24, 16, 4, 16, 40, 16, 2, False, "dot"),
            (96, 8, 4, 2, 4, 96, 4, None, False, "cosine"),
            (500, 32, 10, 8, 16, 10, 10, 3, True, "dot"),
            (400, 16, 8, 4, 8, 5, 3, None, True, "cosine")]


def _corpus(ci, n, m, nat, dup):
    rng = np.random.default_rng(100 + ci)
    if nat:
        centers = rng.standard_normal((nat, m)).astype(np.float32) * 4
        x = (centers[rng.integers(0, nat, n)]
             + rng.standard_normal((n, m)).astype(np.float32) * 0.05)
    else:
        x = rng.standard_normal((n, m)).astype(np.float32)
    if dup:
        x[n // 2:] = x[: n - n // 2]        # exact duplicate rows
    return rng, x


@pytest.mark.parametrize("ci", range(len(_CONFIGS)))
def test_jax_built_database_queries_the_same(ci):
    n, m, p, d, c, k, nprobe, nat, dup, metric = _CONFIGS[ci]
    rng, x = _corpus(ci, n, m, nat, dup)
    jdb = _builder(fdb, x, p, d, c, 1000 + ci, metric).build()
    db = ft.from_jax_arrays(jdb, device="cpu")
    queries = np.stack([x[0], x[-1],
                        rng.standard_normal(m).astype(np.float32) * 10])
    for q in queries:
        _same_results(db.query(q, k=k, nprobe=nprobe),
                      jdb.query(q, k=k, nprobe=nprobe))
    for got, want in zip(db.query_batch(queries, k=k, nprobe=nprobe),
                         jdb.query_batch(queries, k=k, nprobe=nprobe)):
        _same_results(got, want)


def test_query_events_match_jax():
    rng, x = _corpus(0, 300, 16, None, False)
    jdb = _builder(fdb, x, 6, 4, 8, 3).build()
    db = ft.from_jax_arrays(jdb, device="cpu")
    seen, jseen = [], []
    db.query_with_events(x[5], 4, 3, seen.append)
    jdb.query_with_events(x[5], 4, 3, jseen.append)
    assert [(type(e).__name__, getattr(e, "partition_index", None))
            for e in seen] == \
        [(type(e).__name__, getattr(e, "partition_index", None))
         for e in jseen]


@pytest.fixture(scope="module")
def recall_corpus():
    """tests/test_recall.py's corpus and build, through the port."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 64)).astype(np.float32)

    def lowdim(count):
        z = rng.standard_normal((count, 4)).astype(np.float32)
        noise = 0.05 * rng.standard_normal((count, 64)).astype(np.float32)
        return (z @ w + noise).astype(np.float32)

    x, q = lowdim(8000), lowdim(100)
    db = _builder(ft, x, 16, 8, 256, 5, device="cpu").build()
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1, kind="stable")[:, :10]
    return q, db, gt


@pytest.mark.parametrize("nprobe,floor", [(1, 0.5), (16, 0.65)])
def test_port_build_clears_the_recall_floors(recall_corpus, nprobe, floor):
    q, db, gt = recall_corpus
    row = {vid: i for i, vid in enumerate(db.vector_ids)}
    res = db.query_batch(q, k=10, nprobe=nprobe)
    hits = sum(len({row[r.vector_id] for r in rs} & set(gt[b].tolist()))
               for b, rs in enumerate(res))
    assert hits / (len(q) * 10) >= floor


def test_port_rerank_clears_the_recall_floor(recall_corpus):
    """tests/test_recall.py:78's floor: exact rerank of the top 100 at full
    probe reaches recall@10 >= 0.9, no less than the ADC recall, and
    reports exact distances."""
    q, db, gt = recall_corpus
    row = {vid: i for i, vid in enumerate(db.vector_ids)}

    def recall(res):
        return sum(len({row[r.vector_id] for r in rs} & set(gt[b].tolist()))
                   for b, rs in enumerate(res)) / (len(q) * 10)

    base = recall(db.query_batch(q, k=10, nprobe=16))
    res = db.query_batch(q, k=10, nprobe=16, rerank=100)
    assert recall(res) >= max(base, 0.9)
    x0 = db.reconstruct(row[res[0][0].vector_id])
    assert res[0][0].squared_distance == pytest.approx(
        float(((q[0] - x0) ** 2).sum()), rel=1e-4)


def test_port_fit_inertia_within_two_percent_of_jax():
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((8, 6)).astype(np.float32) * 3
    x = np.concatenate([c + 0.05 * rng.standard_normal((50, 6))
                        .astype(np.float32) for c in centers])
    x = x[rng.permutation(len(x))]

    def inertia(cents, idx):
        return float(((x - np.asarray(cents)[np.asarray(idx)]) ** 2).sum())

    ref = jkmeans.fit(jnp.asarray(x)[None], 8, jax.random.key(3))
    got = kmeans.fit(torch.from_numpy(x)[None], 8,
                     torch.Generator().manual_seed(3))
    i_ref = inertia(ref.centroids[0], ref.indices[0])
    i_got = inertia(got.centroids[0], got.indices[0].long())
    assert abs(i_got - i_ref) <= 0.02 * max(i_ref, 1e-9)


def test_same_seed_gives_the_same_ids_and_the_same_build():
    x = np.random.default_rng(1).standard_normal((100, 8)).astype(np.float32)
    a = _builder(ft, x, 4, 2, 4, 9, device="cpu").build()
    b = _builder(ft, x, 4, 2, 4, 9, device="cpu").build()
    j = _builder(fdb, x, 4, 2, 4, 9).build()
    assert a.vector_ids == j.vector_ids
    assert a.vector_ids == b.vector_ids
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.partition_centroids, b.partition_centroids)
    for i in (0, 50, 99):
        np.testing.assert_allclose(a.reconstruct(i), x[i], rtol=1e-4,
                                   atol=1e-5)


def _collapsed(seen):
    """Top-level event names, each run of ClusterEvents as one entry."""
    out = []
    for e in seen:
        name = type(e).__name__
        if name == "ClusterEvent" and out and out[-1] == name:
            continue
        out.append(name if name == "ClusterEvent"
                   else (name, getattr(e, "division", None)))
    return out


def test_build_emits_the_jax_top_level_events():
    x = np.random.default_rng(2).standard_normal((60, 8)).astype(np.float32)
    seen, jseen = [], []
    _builder(ft, x, 3, 2, 4, 1, device="cpu").build(seen.append)
    _builder(fdb, x, 3, 2, 4, 1).build(jseen.append)
    assert _collapsed(seen) == _collapsed(jseen)
    assert any(isinstance(e, events.ClusterEvent) for e in seen)


def _invalid_cases(pkg, extra):
    x = np.zeros((10, 8), np.float32)
    ok = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    return [
        lambda: pkg.DatabaseBuilder(x, **extra).with_partitions(11).build(),
        lambda: (pkg.DatabaseBuilder(x, **extra).with_divisions(3)
                 .with_partitions(2).with_clusters(2).build()),
        lambda: pkg.DatabaseBuilder(x, **extra).with_partitions(2)
        .with_clusters(11).build(),
        lambda: pkg.DatabaseBuilder(x, **extra).with_partitions(0),
        lambda: pkg.DatabaseBuilder(x, **extra).with_divisions(0),
        lambda: pkg.DatabaseBuilder(x, **extra).with_clusters(-1),
        lambda: pkg.DatabaseBuilder(x, **extra).with_metric("hamming"),
        lambda: pkg.DatabaseBuilder(x, dtype=np.int8, **extra),
        lambda: pkg.DatabaseBuilder(np.zeros((2, 2, 2)), **extra),
        lambda: pkg.DatabaseBuilder(np.zeros(8, np.float32), **extra),
        lambda: (pkg.DatabaseBuilder(np.zeros((64, 8), np.float32), **extra)
                 .with_metric("cosine").with_partitions(2).with_clusters(2)
                 .build()),
    ], _builder(pkg, ok, 4, 2, 4, 0, **extra).build()


def test_raises_the_same_invalid_args():
    ours, db = _invalid_cases(ft, {"device": "cpu"})
    theirs, jdb = _invalid_cases(fdb, {})
    q = np.zeros(8, np.float32)
    ours += [lambda: db.query(q, k=5, nprobe=5), lambda: db.query(q, 0, 1),
             lambda: db.query(q, 5, 0), lambda: db.query(q[:4], 5, 1),
             lambda: db.query_batch(np.zeros((2, 4)), 5, 1)]
    theirs += [lambda: jdb.query(q, k=5, nprobe=5),
               lambda: jdb.query(q, 0, 1), lambda: jdb.query(q, 5, 0),
               lambda: jdb.query(q[:4], 5, 1),
               lambda: jdb.query_batch(np.zeros((2, 4)), 5, 1)]
    for i, (mine, ref) in enumerate(zip(ours, theirs)):
        with pytest.raises(errors.InvalidArgs) as got:
            mine()
        with pytest.raises(jerrors.InvalidArgs) as want:
            ref()
        assert str(got.value) == str(want.value), i


def test_unported_options_raise_and_name_their_item(tmp_path):
    x = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    b = ft.DatabaseBuilder(x, device="cpu")
    db = _builder(ft, x, 4, 2, 4, 0, device="cpu").build()
    cases = [(lambda: b.with_opq(), 13), (lambda: b.with_fast_math(), 12),
             (lambda: ft.DatabaseBuilder(x, np.float64), 14),
             (lambda: db.query(x[0], 2, 1, where=object()), 10),
             (lambda: db.query_range(x[0], 1.0, 1), 11),
             (lambda: db.add_vectors(x[:2]), 15)]
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            fn()
    b.with_fast_math(False)                     # the default is accepted
    jdb = _builder(fdb, x, 4, 2, 4, 0).with_opq(2).build()
    with pytest.raises(NotImplementedError, match="item 13"):
        ft.from_jax_arrays(jdb, device="cpu")


def test_port_built_database_saves_and_loads_with_jax(tmp_path):
    from flechasdb_tpu.build import Database as JaxDatabase

    rng, x = _corpus(7, 500, 32, 3, True)
    db = _builder(ft, x, 8, 4, 16, 11, device="cpu").build()
    db.attribute_table[db.vector_ids[0]] = {"label": "first"}
    root = fdb.save_database(JaxDatabase(**ft.to_arrays(db)),
                             fdb.LocalFileSystem(tmp_path))
    stored = fdb.load_database(fdb.LocalFileSystem(tmp_path),
                               f"{root}.binpb")
    for q in (x[0], x[-1], rng.standard_normal(32).astype(np.float32)):
        _same_results(db.query(q, k=10, nprobe=4),
                      stored.query(q, k=10, nprobe=4))
    assert stored.get_attribute(db.vector_ids[0], "label") == "first"
    back = ft.from_jax_arrays(JaxDatabase(**ft.to_arrays(db)), device="cpu")
    _same_results(back.query(x[3], 10, 4), db.query(x[3], 10, 4))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import flechasdb_tpu_torch as ft\n"
        "x = np.random.default_rng(0).standard_normal((200, 16))"
        ".astype(np.float32)\n"
        "db = (ft.DatabaseBuilder(x, device='cpu').with_partitions(4)"
        ".with_divisions(4).with_clusters(8).with_seed(1).build())\n"
        "res = db.query(x[0], k=3, nprobe=2)\n"
        "assert res[0].vector_id == db.vector_ids[0], res\n"
        "assert not [m for m in sys.modules if m == 'flechasdb_tpu'"
        " or m.startswith('flechasdb_tpu.')], 'JAX package imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for root, _, files in os.walk(os.path.join(REPO, "flechasdb_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "import jax" not in text, f
                assert "from flechasdb_tpu " not in text, f
                assert "from flechasdb_tpu." not in text, f
                assert "import flechasdb_tpu\n" not in text, f


def test_host_copies_behave_as_the_originals():
    assert [c.__name__ for c in errors.InvalidArgs.__mro__] == \
        [c.__name__ for c in jerrors.InvalidArgs.__mro__]
    for name in dir(events):
        obj = getattr(events, name)
        if isinstance(obj, type) and issubclass(obj, events.Event):
            ref = getattr(jevents, name)
            assert list(obj.__dataclass_fields__ if obj is not events.Event
                        else []) == list(getattr(
                            ref, "__dataclass_fields__", []))
    assert host.VALID_METRICS == jmetrics.VALID_METRICS
    assert host.PAD_LIMIT == jserving.PAD_LIMIT
    for metric in ("", "l2", "dot", "cosine"):
        assert host.check_metric(metric) == jmetrics.check_metric(metric)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 6))
    np.testing.assert_array_equal(host.normalize_rows(x),
                                  jmetrics.normalize_rows(x))
    for data, size in [(x, None), (x.ravel(), 6), (np.arange(12), 4),
                       (x.astype(np.float32), 6)]:
        np.testing.assert_array_equal(host.as_vector_set(data, size),
                                      jvector.as_vector_set(data, size))
    for data, size in [(np.array([1e300]), None), (x.ravel(), 7),
                       (x.ravel(), None), (x, 5), (np.array(["a"]), 1)]:
        with pytest.raises(errors.InvalidArgs) as got:
            host.as_vector_set(data, size)
        with pytest.raises(jerrors.InvalidArgs) as want:
            jvector.as_vector_set(data, size)
        assert str(got.value) == str(want.value)
    for p, n in [(9, 700), (64, 700), (2, 2300), (100, 100_000)]:
        pidx = rng.integers(0, p, n).astype(np.int32)
        pidx[: n // 3] = 0
        assert host.choose_layout(p, pidx, n) == \
            jserving._choose_layout(p, pidx, n)


@pytest.mark.cuda
def test_slice_on_card_matches_the_cpu_plain_path(cuda):
    from flechasdb_tpu_torch import _kernels

    rng, x = _corpus(3, 3000, 96, None, True)
    _kernels.reset_launches()
    db = _builder(ft, x, 10, 12, 64, 7, device="cuda").build()
    res = db.query_batch(x[:16], k=10, nprobe=3)
    assert _kernels.LAUNCHES["lloyd_round"] > 0
    assert _kernels.LAUNCHES["adc_scan"] > 0
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    for got, want in zip(res, ref.query_batch(x[:16], k=10, nprobe=3)):
        _same_results(got, want)
    cpu = _builder(ft, x, 10, 12, 64, 7, device="cpu").build()
    assert cpu.vector_ids == db.vector_ids

    def pq_err(d):
        recon = d.codebooks[np.arange(12)[None, :], d.codes]
        return float(((d.residues - recon.reshape(len(x), 96)) ** 2).sum())

    assert pq_err(db) <= 1.05 * pq_err(cpu)
