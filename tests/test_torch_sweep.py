"""The JAX sweep's last configurations (``benchmarks/sweep.py``) at a small
size on the CPU, held against the JAX package: the GIST1M shape's widths
(M=960, D=60) and the ``dot`` and ``cosine`` metrics.

* A GIST-shaped database (2,000 × 960 GMM rows, 16 components, intrinsic
  32; P=8, D=60, C=16) built by the JAX package and carried across with
  ``from_jax_arrays`` answers ``query`` and ``query_batch``, with and
  without ``rerank=``, on both layouts as the JAX package does (rows up
  to ties; rel 1e-4, abs 1e-5). On buckets its codes pack into 15 words a
  slot and run through K-A's plain version.
* The port's own build at that shape clears the recall floors of
  ``tests/test_torch_sift.py`` (rerank of the top 100 >= 0.9 and no less
  than the ADC recall; ADC within 0.04 of the JAX build's), and its
  fast-math build's PQ inertia comes within 5% of the full build's.
* In both packages a ``dot`` build is bit-equal to the ``l2`` build with
  the same seed: training is L2 for every metric
  (``flechasdb_tpu/metrics.py:28-30``).
* ``dot`` and ``cosine`` trees at that shape saved by the port load in the
  JAX package with the same metric and the same cold answers, and the
  other way round (``tests/test_torch_stored.py`` holds the same for all
  three metrics at its own small shape).
* A zero query under cosine raises the JAX package's ``InvalidArgs`` on
  the port's in-memory and flat surfaces (the stored one is a case of
  ``tests/test_torch_stored.py::test_errors_carry_the_jax_messages``).

The ``cuda`` test holds a ``dot`` ``DeviceIndex`` batch on the card
against the CPU path and skips here. K-A at packed D=60 and K-B at M=960,
K=1024 on the card are cases of the card tests of
``tests/test_torch_scan.py`` and ``tests/test_torch_lloyd.py``.
"""

import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import flat as jflat
from flechasdb_tpu_torch import _kernels, host, synth
from flechasdb_tpu_torch.serving import DeviceIndex

from _torch_helpers import cuda, same_ranked  # noqa: F401

N, NQ, M, P, D, C, K, NPROBE = 2000, 40, 960, 8, 60, 16, 10, 3
SEED = 3
ARRAYS = ("partition_centroids", "partition_indices", "codebooks", "codes",
          "residues")


@pytest.fixture(scope="module")
def gist():
    """GMM rows at the GIST width and their exact top K (float64)."""
    x, q = synth.gmm_pair(np.random.default_rng(5), N, NQ, M,
                          n_clusters=16, intrinsic=32)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
         - 2.0 * q64 @ x64.T)
    return x, q, np.argsort(d, axis=1, kind="stable")[:, :K]


def _builder(pkg, x, metric="l2", **kw):
    return (pkg.DatabaseBuilder(x, **kw).with_partitions(P)
            .with_divisions(D).with_clusters(C).with_seed(SEED)
            .with_metric(metric))


@pytest.fixture(scope="module")
def jax_gist(gist):
    return _builder(fdb, gist[0]).build()


@pytest.fixture(scope="module")
def port_gist(gist):
    """The port's full and fast-math builds on the CPU."""
    return (_builder(ft, gist[0], device="cpu").build(),
            _builder(ft, gist[0], device="cpu").with_fast_math().build())


def _ranked(db, results):
    """Result lists as ``(keys [B, k], rows [B, k])``."""
    row = {vid: i for i, vid in enumerate(db.vector_ids)}
    return (np.array([[r.squared_distance for r in rs] for rs in results]),
            np.array([[row[r.vector_id] for r in rs] for rs in results]))


def _recall(db, q, gt, **kw):
    rows = _ranked(db, db.query_batch(q, k=K, nprobe=NPROBE, **kw))[1]
    return np.mean([len(set(rows[b]) & set(gt[b])) / K
                    for b in range(len(q))])


@pytest.mark.parametrize("layout", ["bucketed", "masked"])
@pytest.mark.parametrize("rerank", [None, 100])
def test_jax_built_gist_database_answers_the_same(gist, jax_gist, layout,
                                                  rerank, monkeypatch):
    _, q, _ = gist
    monkeypatch.setattr(host, "PAD_LIMIT",
                        float("inf") if layout == "bucketed" else 0.0)
    db = ft.from_jax_arrays(jax_gist, device="cpu")
    index = db._device_state()
    assert index.layout == layout
    if layout == "bucketed":
        assert index.buckets.codes.shape[1] == 15        # packed D=60
    got = db.query_batch(q, K, NPROBE, rerank=rerank)
    want = jax_gist.query_batch(q, K, NPROBE, rerank=rerank)
    same_ranked(*_ranked(db, got), *_ranked(jax_gist, want))
    if rerank is None:
        same_ranked(*_ranked(db, [db.query(q[0], K, NPROBE)]),
                    *_ranked(jax_gist, [jax_gist.query(q[0], K, NPROBE)]))


def test_port_gist_build_clears_the_recall_floors(gist, jax_gist,
                                                  port_gist):
    _, q, gt = gist
    db = port_gist[0]
    assert db.codebooks.shape == (D, C, M // D)
    adc = _recall(db, q, gt)
    reranked = _recall(db, q, gt, rerank=100)
    assert reranked >= 0.9
    assert reranked >= adc
    assert adc >= _recall(jax_gist, q, gt) - 0.04


def _pq_inertia(db):
    """Mean over rows of ‖residue − reconstruction‖²."""
    recon = db.codebooks[np.arange(D)[None, :], db.codes]     # [N, D, m]
    return float(((db.residues - recon.reshape(len(db.codes), M)) ** 2)
                 .sum(1).mean())


def test_port_gist_fast_build_inertia_within_5_percent(port_gist):
    full, fast = port_gist
    assert abs(_pq_inertia(fast) - _pq_inertia(full)) <= \
        0.05 * _pq_inertia(full)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dot_build_is_bit_equal_to_the_l2_build(gist, jax_gist, port_gist,
                                                pkg):
    x = gist[0]
    l2 = jax_gist if pkg == "jax" else port_gist[0]
    dot = (_builder(fdb, x, "dot") if pkg == "jax"
           else _builder(ft, x, "dot", device="cpu")).build()
    assert dot.metric == "dot" and l2.metric == "l2"
    for name in ARRAYS:
        a, b = (np.ascontiguousarray(getattr(db, name)) for db in (dot, l2))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    assert list(dot.vector_ids) == list(l2.vector_ids)


def _fields(results):
    return [(r.vector_id, r.partition_index, r.vector_index,
             r.squared_distance) for r in results]


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_metric_trees_cross_load_at_the_gist_shape(gist, metric, tmp_path):
    """Each package loads the other's tree with its metric; a cold query of
    a tree answers the same, to the bit, in both packages (one host
    scan)."""
    x, q, _ = gist
    roots = {
        "port": ft.save_database(
            _builder(ft, x, metric, device="cpu").build(),
            ft.LocalFileSystem(tmp_path / "port")),
        "jax": fdb.save_database(_builder(fdb, x, metric).build(),
                                 fdb.LocalFileSystem(tmp_path / "jax"))}
    for tree, root in roots.items():
        mine = ft.load_database(ft.LocalFileSystem(tmp_path / tree),
                                f"{root}.binpb", device="cpu")
        theirs = fdb.load_database(fdb.LocalFileSystem(tmp_path / tree),
                                   f"{root}.binpb")
        assert mine.metric == theirs.metric == metric
        assert mine.num_divisions == D
        for v in q[:4]:
            assert _fields(mine.query(v, K, NPROBE)) == \
                _fields(theirs.query(v, K, NPROBE))


@pytest.mark.parametrize("surface", ["memory", "flat"])
def test_zero_cosine_query_raises_the_jax_message(gist, surface):
    x = gist[0][:400]
    zero = np.zeros(M, np.float32)
    if surface == "memory":
        mine = _builder(ft, x, "cosine", device="cpu").build()
        theirs = _builder(fdb, x, "cosine").build()
        calls = [lambda db: db.query(zero, K, NPROBE),
                 lambda db: db.query_batch(zero[None], K, NPROBE),
                 lambda db: db.query_range(zero, 1.0, NPROBE)]
    else:
        mine = ft.FlatDatabase(x, seed=1, metric="cosine", device="cpu")
        theirs = jflat.FlatDatabase(x, seed=1, metric="cosine")
        calls = [lambda db: db.query(zero, K),
                 lambda db: db.query_batch(zero[None], K),
                 lambda db: db.query_range(zero, 1.0)]
    for call in calls:
        with pytest.raises(fdb.InvalidArgs) as want:
            call(theirs)
        with pytest.raises(ft.InvalidArgs) as got:
            call(mine)
        assert str(got.value) == str(want.value)
        assert "has zero norm" in str(got.value)


@pytest.mark.cuda
def test_dot_device_index_on_card_matches_cpu(cuda, gist):  # noqa: F811
    """A ``dot`` bucketed batch through K-A on the card, with and without
    rerank, against the same index on the CPU."""
    x, q, _ = gist
    db = _builder(ft, x, "dot", device="cpu").build()
    arrays = (db.partition_centroids, db.codebooks, db.codes.astype(np.int32),
              db.partition_indices)
    orig = db.residues + db.partition_centroids[db.partition_indices]
    on_card = DeviceIndex(*arrays, layout="bucketed", metric="dot",
                          device=cuda)
    on_cpu = DeviceIndex(*arrays, layout="bucketed", metric="dot",
                         device="cpu")
    before = _kernels.LAUNCHES["adc_scan"]
    got = on_card.query(q, K, NPROBE)
    assert _kernels.LAUNCHES["adc_scan"] == before + 1
    want = on_cpu.query(q, K, NPROBE)
    np.testing.assert_array_equal(got[2], want[2])
    same_ranked(got[0], got[1], want[0], want[1])
    same_ranked(*on_card.query_rerank(q, torch.as_tensor(orig, device=cuda),
                                      K, NPROBE, 100),
                *on_cpu.query_rerank(q, torch.as_tensor(orig), K, NPROBE,
                                     100))
