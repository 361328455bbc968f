"""The masked layout of the PyTorch port (``ops.adc.query_masked_scan``,
``masked_scan_keys``, ``serving.DeviceIndex(layout=...)`` and its batch
chunking), against the JAX package and against the port's own bucketed
layout (``tests/test_bucketed.py:37``).

Tolerance: distances within rel 1e-4, abs 1e-5 (sums of D f32 table
entries taken in another order); rows equal except where two candidates'
distances tie; probed partitions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import serving as jserving
from flechasdb_tpu.ops import adc as jadc
from flechasdb_tpu_torch import serving
from flechasdb_tpu_torch.ops import adc
from flechasdb_tpu_torch.ops.bucketed import bucketize, query_bucketed

RTOL, ATOL = 1e-4, 1e-5


def _random_index(rng, n=700, m=64, p=9, d=4, c=16):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return centroids, codebooks, codes, pidx


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close_up_to_ties(got, want):
    gd, gr, gp = got
    wd, wr, wp = want
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=RTOL, atol=ATOL)
    differ = (gr != wr) & fin
    for b in range(len(gd)):
        for i in np.flatnonzero(differ[b]):
            # The swapped row sits at a tied distance in the other list,
            # or at the last slot, tied across the cut.
            twin = np.flatnonzero(wr[b] == gr[b, i])
            assert (twin.size and np.isclose(wd[b, twin[0]], gd[b, i],
                                             rtol=RTOL, atol=ATOL)) \
                or i == len(gd[b]) - 1


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 10), (9, 10), (2, 900)])
def test_masked_scan_matches_jax(metric, nprobe, k):
    rng = np.random.default_rng(nprobe * 7 + k)
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((6, centroids.shape[1])).astype(np.float32)
    got = adc.query_masked_scan(*_t(q, centroids, codebooks, codes, pidx),
                                k=k, nprobe=nprobe, metric=metric)
    want = jadc.query_masked_scan(
        *[jnp.asarray(a) for a in (q, centroids, codebooks, codes, pidx)],
        k=k, nprobe=nprobe, metric=metric)
    _close_up_to_ties([a.numpy() for a in got],
                      [np.asarray(a) for a in want])


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_masked_scan_keys_match_jax(metric):
    rng = np.random.default_rng(3)
    centroids, codebooks, codes, pidx = _random_index(rng, n=300, c=200)
    q = rng.standard_normal((4, centroids.shape[1])).astype(np.float32)
    vdist, coarse = adc.masked_scan_keys(
        *_t(q, centroids, codebooks, codes, pidx), metric)
    jv, jc = jadc.masked_scan_keys(
        *[jnp.asarray(a) for a in (q, centroids, codebooks, codes, pidx)],
        None, metric)
    np.testing.assert_allclose(vdist.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("nprobe", [1, 3, 9])
def test_bucketed_matches_masked_in_the_port(nprobe):
    rng = np.random.default_rng(40 + nprobe)
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((6, centroids.shape[1])).astype(np.float32)
    qt, ct, cbt = _t(q, centroids, codebooks)
    masked = adc.query_masked_scan(qt, ct, cbt, *_t(codes, pidx), k=10,
                                   nprobe=nprobe)
    bucketed = query_bucketed(qt, ct, cbt, bucketize(codes, pidx, 9),
                              k=10, nprobe=nprobe)
    _close_up_to_ties([a.numpy() for a in bucketed],
                      [a.numpy() for a in masked])


@pytest.mark.parametrize("metric,per_query", [
    # SIFT shape: L2's table build (2·P·D·C + 2·P·M f32) exceeds its sort
    # (16 bytes a row); dot holds no tables.
    ("l2", 8 * (1024 * 8 * 256 + 1024 * 128)),
    ("dot", 16 * 1_000_000)])
def test_masked_limit_counts_the_ports_transients(metric, per_query):
    cent, cb, n = (1024, 128), (8, 256, 16), 1_000_000
    budget = serving.HBM_BUDGET_BYTES
    assert budget == jserving.HBM_BUDGET_BYTES
    limit = serving._masked_limit(cent, cb, n, budget, metric)
    assert limit == (budget - 16 * n) // per_query
    # Eager PyTorch never holds the [B, n, D] gather the JAX estimate counts.
    assert limit > jserving._masked_limit(cent, cb, n, budget, metric)
    assert serving._masked_limit(cent, cb, n, 1, metric) == 1


@pytest.mark.parametrize("seed", range(4))
def test_smallest_k_is_the_stable_sorts_prefix(seed):
    """Ties (±0, ±inf, repeated values) keep the lower index, as a stable
    sort and ``lax.top_k`` do; the values are the sorted keys."""
    rng = np.random.default_rng(seed)
    pool = np.array([-np.inf, -3.5, -1.0, -0.0, 0.0, 1e-38, 2.0, 7.25,
                     np.inf], np.float32)
    keys = rng.choice(pool, size=(5, 300))
    if seed % 2:
        keys = keys + rng.standard_normal(keys.shape).astype(np.float32)
    t = torch.from_numpy(keys.astype(np.float32))
    for k in (1, 10, 300):
        values, idx = adc.smallest_k(t, k)
        want = torch.sort(t, dim=1, stable=True)
        assert torch.equal(idx, want.indices[:, :k])
        assert torch.equal(values, want.values[:, :k])


def test_masked_scan_returns_no_view_of_its_sort():
    """Each output owns only its own elements, so the chunks of a batch
    do not keep their whole ``[B, N]`` sorts alive."""
    rng = np.random.default_rng(12)
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((3, centroids.shape[1])).astype(np.float32)
    for out in adc.query_masked_scan(*_t(q, centroids, codebooks, codes,
                                         pidx), k=10, nprobe=3):
        assert out.untyped_storage().nbytes() == \
            out.numel() * out.element_size()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_masked_scan_peak_fits_the_budget_on_card(metric):
    """The device memory a chunk of the masked scan takes above what was
    allocated before it stays within ``hbm_budget_bytes``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    centroids, codebooks, codes, pidx = _random_index(
        rng, n=200_000, m=128, p=256, d=8, c=256)
    q = rng.standard_normal((300, 128)).astype(np.float32)
    budget = 256 << 20
    index = serving.DeviceIndex(centroids, codebooks, codes, pidx,
                                layout="masked", metric=metric,
                                hbm_budget_bytes=budget)
    assert 1 < index._masked_batch_limit() < len(q)
    index.query(q, 10, 4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    index.query(q, 10, 4)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= budget


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_device_index_chunks_masked_batches(metric):
    rng = np.random.default_rng(5)
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((11, centroids.shape[1])).astype(np.float32)
    whole = serving.DeviceIndex(centroids, codebooks, codes, pidx,
                                layout="masked", metric=metric, device="cpu")
    small = serving.DeviceIndex(centroids, codebooks, codes, pidx,
                                layout="masked", metric=metric, device="cpu",
                                hbm_budget_bytes=1)
    assert small._masked_batch_limit() == 1
    assert whole._masked_batch_limit() >= len(q)
    # One query a chunk: the products run at another batch size, so the
    # last bits may move.
    _close_up_to_ties(small.query(q, 10, 3), whole.query(q, 10, 3))
    ref = jserving.DeviceIndex(centroids, codebooks, codes, pidx,
                               layout="masked", metric=metric,
                               hbm_budget_bytes=1)
    _close_up_to_ties(small.query(q, 10, 3), ref.query(q, 10, 3))


def test_layout_choice_and_errors():
    rng = np.random.default_rng(6)
    centroids, codebooks, codes, pidx = _random_index(rng)
    skewed = pidx.copy()
    skewed[: len(pidx) * 9 // 10] = 0
    for p_idx, want in [(pidx, "bucketed"), (skewed, "masked")]:
        ours = serving.DeviceIndex(centroids, codebooks, codes, p_idx,
                                   device="cpu")
        theirs = jserving.DeviceIndex(centroids, codebooks, codes, p_idx)
        assert ours.layout == theirs.layout == want
    with pytest.raises(ValueError, match="unknown layout"):
        serving.DeviceIndex(centroids, codebooks, codes, pidx,
                            layout="flat", device="cpu")


def test_skewed_jax_database_serves_from_the_masked_layout():
    """A corpus whose partitions are too skewed for buckets takes the
    masked layout in both packages and answers the same, with and
    without rerank."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((600, 16)).astype(np.float32) * 0.01
    x[:30] += rng.standard_normal((30, 16)).astype(np.float32) * 20
    jdb = (fdb.DatabaseBuilder(x).with_partitions(30).with_divisions(4)
           .with_clusters(8).with_seed(8).build())
    db = ft.from_jax_arrays(jdb, device="cpu")
    assert db._device_state().layout == jdb._device_state().layout == \
        "masked"
    q = np.concatenate([x[:2], x[100:102]])
    for rerank in (None, 20):
        got = db.query_batch(q, k=6, nprobe=4, rerank=rerank)
        want = jdb.query_batch(q, k=6, nprobe=4, rerank=rerank)
        for g, w in zip(got, want):
            assert [r.squared_distance for r in g] == pytest.approx(
                [r.squared_distance for r in w], rel=RTOL, abs=ATOL)
            assert {r.vector_id for r in g[:-1]} <= {r.vector_id for r in w}


def test_skewed_database_answers_as_a_bucketed_index():
    """A skewed corpus's database serves from the masked layout; a
    ``DeviceIndex(layout="bucketed")`` over its arrays (how the JAX
    package's sweep serves the SIFT shape) answers the same, with and
    without rerank."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((600, 16)).astype(np.float32) * 0.01
    x[:30] += rng.standard_normal((30, 16)).astype(np.float32) * 20
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(30)
          .with_divisions(4).with_clusters(8).with_seed(9).build())
    assert db._device_state().layout == "masked"
    index = serving.DeviceIndex(db.partition_centroids, db.codebooks,
                                db.codes.astype(np.int32),
                                db.partition_indices, layout="bucketed",
                                device="cpu")
    q = np.concatenate([x[:2], x[200:202]])
    _close_up_to_ties(index.query(q, 6, 4), db._device_state().query(q, 6, 4))
    want = db.query_batch(q, k=6, nprobe=4, rerank=20)
    dists, rows = index.query_rerank(q, db._device_originals(), k=6,
                                     nprobe=4, rerank=20)
    for b, w in enumerate(want):
        assert dists[b, :len(w)].tolist() == pytest.approx(
            [r.squared_distance for r in w], rel=RTOL, abs=ATOL)
        assert {db.vector_ids[r] for r in rows[b, :len(w) - 1]} <= \
            {r.vector_id for r in w}
