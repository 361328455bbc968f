"""Exact rerank in the PyTorch port (``query_batch(rerank=)``,
``DeviceIndex.query_rerank``, ``serving._rerank_exact``) and
``DatabaseBuilder.with_residues``, against the JAX package.

A database the JAX package built, carried across by ``from_jax_arrays``,
answers ``query_batch(..., rerank=R)`` with the same rows up to
exact-distance ties, distances within rel 1e-4, abs 1e-5
(``tests/test_stored.py``'s bound), for l2, dot and cosine, on both
layouts; the validation errors carry the JAX package's messages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu.build import _rerank_exact as jax_rerank
from flechasdb_tpu_torch import errors, serving

RTOL, ATOL = 1e-4, 1e-5


def same_up_to_ties(got, want):
    """Distances position by position; a row may differ from the JAX
    package's only where its distance ties another returned row's."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.squared_distance == pytest.approx(w.squared_distance,
                                                   rel=RTOL, abs=ATOL)
    want_ids = {w.vector_id: w.squared_distance for w in want}
    for i, g in enumerate(got):
        if g.vector_id == want[i].vector_id:
            continue
        twin = want_ids.get(g.vector_id)
        tied = twin is not None and twin == pytest.approx(
            g.squared_distance, rel=RTOL, abs=ATOL)
        # The last slot may hold either of two rows tied across the cut.
        assert tied or i == len(got) - 1 and g.squared_distance == \
            pytest.approx(want[i].squared_distance, rel=RTOL, abs=ATOL)


def _corpus(seed, n, m, dup):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, m)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 6, n)]
         + rng.standard_normal((n, m)).astype(np.float32) * 0.3)
    if dup:
        x[n // 2:] = x[: n - n // 2]        # exact duplicate rows
    return rng, x


def _build(pkg, x, p, d, c, seed, metric, **kw):
    return (pkg.DatabaseBuilder(x, **kw).with_partitions(p)
            .with_divisions(d).with_clusters(c).with_seed(seed)
            .with_metric(metric).build())


@pytest.mark.parametrize("metric,dup", [("l2", False), ("l2", True),
                                        ("dot", False), ("cosine", True)])
def test_rerank_of_a_jax_built_database_matches_jax(metric, dup):
    rng, x = _corpus(11, 600, 32, dup)
    jdb = _build(fdb, x, 8, 4, 16, 21, metric)
    db = ft.from_jax_arrays(jdb, device="cpu")
    q = np.concatenate([x[:3], rng.standard_normal((3, 32))
                        .astype(np.float32) * 3])
    for k, nprobe, rerank in [(5, 3, 40), (10, 8, 10), (3, 2, 200)]:
        got = db.query_batch(q, k=k, nprobe=nprobe, rerank=rerank)
        want = jdb.query_batch(q, k=k, nprobe=nprobe, rerank=rerank)
        for g, w in zip(got, want):
            same_up_to_ties(g, w)


def test_rerank_over_every_candidate_is_the_exact_top_k():
    rng, x = _corpus(12, 800, 32, False)
    db = _build(ft, x, 8, 4, 16, 22, "l2", device="cpu")
    q = rng.standard_normal((4, 32)).astype(np.float32) * 3
    row = {vid: i for i, vid in enumerate(db.vector_ids)}
    res = db.query_batch(q, k=10, nprobe=8, rerank=800)
    for b, rs in enumerate(res):
        exact = ((x - q[b]) ** 2).sum(-1)
        want = np.argsort(exact, kind="stable")[:10]
        assert [row[r.vector_id] for r in rs] == want.tolist()
        np.testing.assert_allclose([r.squared_distance for r in rs],
                                   exact[want], rtol=RTOL, atol=ATOL)


def test_rerank_exact_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    x[10] = x[3]                                # an exact tie
    q = rng.standard_normal((4, 8)).astype(np.float32)
    q[0] = x[3]
    rows = rng.integers(0, 50, (4, 12)).astype(np.int32)
    rows[0, :4] = [10, 3, 7, 3]
    valid = rng.random((4, 12)) > 0.2
    valid[:, 0] = True
    for metric in ("l2", "dot"):
        d, r = serving._rerank_exact(
            torch.from_numpy(q), torch.from_numpy(rows),
            torch.from_numpy(valid), torch.from_numpy(x), k=6, metric=metric)
        jd, jr = jax_rerank(jnp.asarray(q), jnp.asarray(rows),
                            jnp.asarray(valid), jnp.asarray(x), k=6,
                            metric=metric)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL,
                                   atol=ATOL)


def test_rerank_on_both_layouts_agrees():
    rng, x = _corpus(14, 500, 16, True)
    db = _build(ft, x, 6, 4, 8, 23, "l2", device="cpu")
    q = np.concatenate([x[:2], rng.standard_normal((2, 16))
                        .astype(np.float32)])
    orig = db._device_originals()
    bucketed = db._device_state()
    masked = serving.DeviceIndex(
        db.partition_centroids, db.codebooks, db.codes.astype(np.int32),
        db.partition_indices, layout="masked", device="cpu")
    got = masked.query_rerank(q, orig, k=7, nprobe=3, rerank=30)
    want = bucketed.query_rerank(q, orig, k=7, nprobe=3, rerank=30)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    differ = got[1] != want[1]
    np.testing.assert_allclose(got[0][differ], want[0][differ], rtol=1e-6)
    assert (got[1] != want[1]).sum() < got[1].size // 4


def test_rerank_validation_matches_jax():
    _, x = _corpus(15, 300, 16, False)
    ours = _build(ft, x, 4, 4, 8, 24, "l2", device="cpu")
    theirs = _build(fdb, x, 4, 4, 8, 24, "l2")
    ours_bare = (ft.DatabaseBuilder(x, device="cpu").with_partitions(4)
                 .with_divisions(4).with_clusters(8).with_seed(24)
                 .with_residues(False).build())
    theirs_bare = (fdb.DatabaseBuilder(x).with_partitions(4)
                   .with_divisions(4).with_clusters(8).with_seed(24)
                   .with_residues(False).build())
    assert ours_bare.residues is None and theirs_bare.residues is None
    cases = [(ours, theirs, dict(k=10, nprobe=4, rerank=5)),
             (ours, theirs, dict(k=0, nprobe=4, rerank=5)),
             (ours_bare, theirs_bare, dict(k=5, nprobe=4, rerank=20))]
    for mine, ref, kw in cases:
        with pytest.raises(errors.InvalidArgs) as got:
            mine.query_batch(x[:2], **kw)
        with pytest.raises(jerrors.InvalidArgs) as want:
            ref.query_batch(x[:2], **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(errors.InvalidArgs) as got:
        ours_bare.reconstruct(0)
    with pytest.raises(jerrors.InvalidArgs) as want:
        theirs_bare.reconstruct(0)
    assert str(got.value) == str(want.value)
    # Without residues the build and its ADC queries are unchanged.
    for g, w in zip(ours_bare.query_batch(x[:3], k=5, nprobe=2),
                    ours.query_batch(x[:3], k=5, nprobe=2)):
        assert [r.vector_id for r in g] == [r.vector_id for r in w]
