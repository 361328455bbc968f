"""Updates in the PyTorch port (``ops.encode``, ``Database.add_vectors`` /
``remove_vectors``) against the JAX package on identical inputs.

The same seed gives the same new ids; encoding equals the JAX package's
except at near-ties of two centroids (counted); queries after an add or
a removal return the JAX package's rows, up to distance ties, distances
within rel 1e-4, abs 1e-5. The card tests hold ``encode`` and an add on
the card against the CPU; they carry the ``cuda`` marker and skip here.
"""

import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from _torch_helpers import cuda, midpoint_radius, same_results  # noqa
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu.build import Database as JaxDatabase
from flechasdb_tpu.ops.encode import encode as jencode
from flechasdb_tpu_torch import errors
from flechasdb_tpu_torch.ops.encode import encode

TIE_REL = 1e-5          # two centroids this close to a tie may swap


@pytest.fixture(scope="module")
def built():
    """One JAX build a metric: ``{metric: (fields, x)}``."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    out = {}
    for metric in ("l2", "dot", "cosine"):
        jdb = (fdb.DatabaseBuilder(x).with_partitions(8).with_divisions(4)
               .with_clusters(16).with_seed(21).with_metric(metric).build())
        out[metric] = (ft.to_arrays(jdb), x)
    return out


def _pair(built, metric="l2"):
    """Fresh JAX and port databases on copies of one build's fields."""
    fields, x = built[metric]

    def copy():
        return dict(fields, vector_ids=list(fields["vector_ids"]),
                    attribute_table={})
    return ft.Database(**copy(), device="cpu"), JaxDatabase(**copy()), x


def _near_ties(x, cents, got, want):
    """Rows where two assignments differ; each must be a near-tie of its
    two centroids (float64 distances)."""
    bad = np.flatnonzero(got != want)
    for i in bad:
        dg, dw = (float(((x[i].astype(np.float64) - cents[c]) ** 2).sum())
                  for c in (got[i], want[i]))
        assert abs(dg - dw) <= TIE_REL * max(dg, dw, 1e-12), i
    return len(bad)


@pytest.mark.parametrize("p,d,c", [(9, 4, 16), (70_000, 2, 300),
                                   (5, 8, 256)])
def test_encode_matches_jax(p, d, c):
    rng = np.random.default_rng(p + c)
    m = 8 * d
    x = rng.standard_normal((300, m)).astype(np.float32)
    cents = rng.standard_normal((p, m)).astype(np.float32)
    cbs = rng.standard_normal((d, c, m // d)).astype(np.float32)
    pidx, codes = (t.numpy() for t in encode(
        torch.from_numpy(x), torch.from_numpy(cents), torch.from_numpy(cbs)))
    jp, jc = (np.asarray(a) for a in jencode(
        jnp.asarray(x), jnp.asarray(cents), jnp.asarray(cbs)))
    assert pidx.dtype == jp.dtype == (np.uint16 if p <= 65536 else np.int32)
    assert codes.dtype == jc.dtype == (np.uint8 if c <= 256 else np.int32)
    assert codes.shape == jc.shape == (300, d)
    ties = _near_ties(x, cents, pidx, jp)
    same = pidx == jp                    # codes compare on equal partitions
    resid = (x - cents[pidx]).reshape(300, d, m // d)
    for j in range(d):
        ties += _near_ties(resid[same, j], cbs[j], codes[same, j],
                           jc[same, j])
    assert ties <= 3


def test_encode_gives_back_the_build():
    """Encoding the rows a port build indexed gives back their partitions
    and codes: the build's last assignment is against its final centroids
    up to a converged fit's last update (JAX ``tests/test_update.py``)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1200, 32)).astype(np.float32)
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(8)
          .with_divisions(4).with_clusters(16).with_seed(2).build())
    pidx, codes = (t.numpy() for t in encode(
        torch.from_numpy(x), torch.from_numpy(db.partition_centroids),
        torch.from_numpy(db.codebooks)))
    np.testing.assert_array_equal(pidx[:50], db.partition_indices[:50])
    np.testing.assert_array_equal(codes[:50], db.codes[:50])
    assert (pidx != db.partition_indices).mean() < 0.01
    assert (codes != db.codes).mean() < 0.01


@pytest.mark.parametrize("seed", [0, 7])
def test_add_vectors_returns_the_jax_ids(built, seed):
    db, jdb, x = _pair(built)
    new = np.random.default_rng(seed).standard_normal((30, 32)) \
        .astype(np.float32)
    ids = db.add_vectors(new, seed=seed)
    assert ids == jdb.add_vectors(new, seed=seed)
    assert db.vector_ids == jdb.vector_ids and db.num_vectors == 1030
    np.testing.assert_array_equal(db.partition_indices, jdb.partition_indices)
    np.testing.assert_array_equal(db.codes, jdb.codes)
    assert db.codes.dtype == jdb.codes.dtype == np.uint32
    assert db.partition_indices.dtype == np.int32
    np.testing.assert_allclose(db.residues, jdb.residues, rtol=1e-6)
    mine = [uuid.UUID(int=i + 1) for i in range(2)]
    assert db.add_vectors(new[:2], vector_ids=mine) == mine
    assert db.vector_ids[-2:] == mine


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_queries_after_add_match_jax(built, metric):
    db, jdb, x = _pair(built, metric)
    rng = np.random.default_rng(5)
    new = rng.standard_normal((40, 32)).astype(np.float32)
    db.query(x[0], 5, 8)                        # a device index to drop
    ids = db.add_vectors(new, seed=3)
    jdb.add_vectors(new, seed=3)
    assert db._dev is None and db._dev_orig is None
    queries = np.concatenate([new[:6], x[:3]])
    for rr in (None, 20):
        for got, want in zip(db.query_batch(queries, 5, 8, rerank=rr),
                             jdb.query_batch(queries, 5, 8, rerank=rr)):
            same_results(got, want)
    for i in range(6):                  # an added row finds itself
        res = db.query(new[i], k=5, nprobe=8)
        assert ids[i] in [r.vector_id for r in res]
        same_results(res, jdb.query(new[i], k=5, nprobe=8))
    np.testing.assert_array_equal(db.local_indices, jdb.local_indices)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_queries_after_remove_match_jax(built, metric):
    """Removing rows, among them every row of partition 3, which then
    reaches the scan as an empty bucket."""
    db, jdb, x = _pair(built, metric)
    db.query(x[0], 5, 8)
    gone = set(np.flatnonzero(db.partition_indices == 3).tolist()) \
        | set(range(0, 1000, 7))
    doomed = [db.vector_ids[i] for i in sorted(gone)]
    assert db.remove_vectors(doomed) == len(gone)
    assert jdb.remove_vectors(doomed) == len(gone)
    assert db.vector_ids == jdb.vector_ids
    assert 3 not in db.partition_indices
    assert db._device_state().buckets.lengths[3] == 0
    queries = np.concatenate([x[:4], x[7:8]]) + 0.01
    for rr in (None, 60):
        for got, want in zip(db.query_batch(queries, 40, 8, rerank=rr),
                             jdb.query_batch(queries, 40, 8, rerank=rr)):
            same_results(got, want)
            assert not {r.vector_id for r in got} & set(doomed)
    every = jdb.query_range(queries[0], 3e38, nprobe=8)
    radius = midpoint_radius([r.squared_distance for r in every], 0.5)
    same_results(db.query_range(queries[0], radius, 8),
                 jdb.query_range(queries[0], radius, 8))


def test_remove_drops_the_attribute_entries(built):
    db, jdb, x = _pair(built)
    for d in (db, jdb):
        for i in (3, 4, 5):
            d.set_attribute_at(i, ("idx", i))
    victims = [db.vector_ids[3], db.vector_ids[5]]
    assert db.remove_vectors(victims) == jdb.remove_vectors(victims) == 2
    assert db.attribute_table == jdb.attribute_table
    assert db.get_attribute(db.vector_ids[3], "idx") == 4
    assert victims[0] not in db.attribute_table
    with pytest.raises(errors.InvalidArgs) as got:
        db.get_attribute(victims[0], "idx")
    with pytest.raises(jerrors.InvalidArgs) as want:
        jdb.get_attribute(victims[0], "idx")
    assert str(got.value) == str(want.value)
    assert db.remove_vectors([]) == jdb.remove_vectors([]) == 0


def _bad_updates(d, x, victim):
    return [lambda: d.add_vectors(np.zeros((3, 7), np.float32)),
            lambda: d.add_vectors(x[:3], vector_ids=[]),
            lambda: d.add_vectors(x[:3], vector_ids=d.vector_ids[:2]),
            lambda: d.add_vectors(np.zeros((2, 2, 2), np.float32)),
            lambda: d.remove_vectors([victim]),
            lambda: d.remove_vectors([d.vector_ids[0], victim])]


def test_update_validation_errors_match_jax(built):
    db, jdb, x = _pair(built)
    victim = db.vector_ids[9]
    assert db.remove_vectors([victim]) == jdb.remove_vectors([victim])
    for mine, ref in zip(_bad_updates(db, x, victim),
                         _bad_updates(jdb, x, victim)):
        with pytest.raises(errors.InvalidArgs) as got:
            mine()
        with pytest.raises(jerrors.InvalidArgs) as want:
            ref()
        assert str(got.value) == str(want.value)
    assert db.num_vectors == jdb.num_vectors == 999
    cos, jcos, _ = _pair(built, "cosine")
    zero = np.zeros((2, 32), np.float32)
    with pytest.raises(errors.InvalidArgs) as got:
        cos.add_vectors(zero)
    with pytest.raises(jerrors.InvalidArgs) as want:
        jcos.add_vectors(zero)
    assert str(got.value) == str(want.value)


def test_updates_invalidate_the_filter_cache(built):
    db, jdb, x = _pair(built)
    for i in range(0, 1000, 2):
        db.set_attribute_at(i, ("even", 1))
        jdb.set_attribute_at(i, ("even", 1))
    q = x[11] + 0.01
    before = db.query(q, 5, 8, where=ft.Eq("even", 1))
    assert len(db._filter_mask(ft.Eq("even", 1))) == 1000
    for d in (db, jdb):
        d.add_vectors(x[11:12], seed=1)
        d.set_attribute_at(1000, ("even", 1))
    after = db.query(q, 5, 8, where=ft.Eq("even", 1))
    assert after[0].vector_id == db.vector_ids[1000] != before[0].vector_id
    same_results(after, jdb.query(q, 5, 8, where=fdb.Eq("even", 1)))
    for d in (db, jdb):
        d.remove_vectors([d.vector_ids[1000]])
    same_results(db.query(q, 5, 8, where=ft.Eq("even", 1)), before)
    same_results(db.query_batch(x[:3], 4, 8, where=ft.Eq("even", 1))[0],
                 jdb.query_batch(x[:3], 4, 8, where=fdb.Eq("even", 1))[0])


def test_add_grows_the_bucket_length(built):
    """Rows added to one partition push it past its 128-slot bucket; the
    rebuilt index scans at the new length, as the JAX package's."""
    db, jdb, x = _pair(built)
    l0 = db._device_state().buckets.codes.shape[2]
    target = int(np.argmax(np.bincount(db.partition_indices)))
    row = int(np.flatnonzero(db.partition_indices == target)[0])
    new = np.repeat(x[row:row + 1], 130, axis=0) + 1e-3 * np.random \
        .default_rng(6).standard_normal((130, 32)).astype(np.float32)
    for d in (db, jdb):
        d.add_vectors(new, seed=4)
    assert db._device_state().buckets.codes.shape[2] == l0 + 128
    same_results(db.query(new[0], 20, 1), jdb.query(new[0], 20, 1))


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_encode_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(40)
    x = rng.standard_normal((5000, 96)).astype(np.float32)
    cents = rng.standard_normal((100, 96)).astype(np.float32)
    cbs = rng.standard_normal((12, 256, 8)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, cents, cbs)]
    card = [a.cpu().numpy() for a in encode(*(a.to(cuda) for a in t))]
    cpu = [a.numpy() for a in encode(*t)]
    assert [a.dtype for a in card] == [np.uint16, np.uint8]
    ties = _near_ties(x, cents, card[0], cpu[0])
    same = card[0] == cpu[0]
    resid = (x - cents[card[0]]).reshape(5000, 12, 8)
    for j in range(12):
        ties += _near_ties(resid[same, j], cbs[j], card[1][same, j],
                           cpu[1][same, j])
    assert ties <= 5


@pytest.mark.cuda
def test_add_and_remove_on_card_match_the_cpu_path(cuda, built):
    db, _, x = _pair(built)
    card = ft.Database(**ft.to_arrays(db), device="cuda")
    new = np.random.default_rng(41).standard_normal((50, 32)) \
        .astype(np.float32)
    ids = card.add_vectors(new, seed=2)
    assert db.add_vectors(new, seed=2) == ids
    np.testing.assert_array_equal(card.partition_indices,
                                  db.partition_indices)
    for got, want in zip(card.query_batch(new[:8], 5, 8),
                         db.query_batch(new[:8], 5, 8)):
        same_results(got, want)
    for d in (card, db):
        d.remove_vectors(ids[:25])
    for got, want in zip(card.query_batch(x[:8], 5, 8),
                         db.query_batch(x[:8], 5, 8)):
        same_results(got, want)
