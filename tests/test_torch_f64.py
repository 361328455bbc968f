"""The port's f64 build (``DatabaseBuilder(x, np.float64)``) against the
JAX package's: both train on the host through the numpy oracle after the
same draws, so the same seed gives the same database array for array, the
same events and the same errors; a saved f64 database is the JAX
package's tree byte for byte and answers after a round trip.
"""

from pathlib import Path

import numpy as np
import pytest

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu_torch import errors

FIELDS = ("partition_centroids", "partition_indices", "codebooks", "codes",
          "residues")


def _x(seed=3, n=400, m=16):
    return np.random.default_rng(seed).standard_normal((n, m))


def _pair(x, p=4, d=4, c=8, seed=11, metric="l2", residues=True):
    ours = (ft.DatabaseBuilder(x, np.float64, device="cpu")
            .with_partitions(p).with_divisions(d).with_clusters(c)
            .with_seed(seed).with_metric(metric).with_residues(residues))
    theirs = (fdb.DatabaseBuilder(x, dtype=np.float64).with_partitions(p)
              .with_divisions(d).with_clusters(c).with_seed(seed)
              .with_metric(metric).with_residues(residues))
    return ours, theirs


@pytest.mark.parametrize("metric, shape, pdc, seed", [
    ("l2", (400, 16), (4, 4, 8), 11),
    ("cosine", (300, 12), (5, 3, 6), 2),
    ("dot", (250, 8), (3, 2, 16), 7),
])
def test_f64_build_is_the_jax_f64_database(metric, shape, pdc, seed):
    x = _x(seed, *shape)
    ours, theirs = _pair(x, *pdc, seed=seed, metric=metric)
    db, jdb = ours.build(), theirs.build()
    assert db.vector_ids == jdb.vector_ids
    assert db.metric == jdb.metric == metric
    assert db.rotation is None and jdb.rotation is None
    for name in FIELDS:
        got, want = getattr(db, name), getattr(jdb, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert db.partition_centroids.dtype == np.float32


def test_f64_build_without_residues():
    ours, theirs = _pair(_x(4), residues=False)
    db, jdb = ours.build(), theirs.build()
    assert db.residues is None and jdb.residues is None
    np.testing.assert_array_equal(db.codes, jdb.codes)


def test_f64_build_emits_the_jax_events():
    x = _x(5)
    ours, theirs = _pair(x)
    got, want = [], []
    ours.build_with_events(got.append)
    theirs.build_with_events(want.append)
    assert [repr(e) for e in got] == [repr(e) for e in want]
    assert type(got[2]).__name__ == "StartingPartitioning"


def _raises_alike(mine, ref, match):
    with pytest.raises(errors.InvalidArgs, match=match) as got:
        mine()
    with pytest.raises(jerrors.InvalidArgs, match=match) as want:
        ref()
    assert str(got.value) == str(want.value)


def test_f64_fast_math_raises_as_in_jax():
    ours, theirs = _pair(_x(6))
    _raises_alike(ours.with_fast_math().build,
                  theirs.with_fast_math().build, "fast_math")


def test_f64_opq_raises_as_in_jax():
    ours, theirs = _pair(_x(6))
    _raises_alike(ours.with_opq(2).build, theirs.with_opq(2).build, "OPQ")


def test_f64_overflow_raises_as_in_jax():
    bad = _x(7)
    bad[0, 0] = 1e39
    ours, theirs = _pair(bad)
    _raises_alike(ours.build, theirs.build, "overflows f32")


@pytest.mark.parametrize("vs", [np.zeros((2, 2, 2)), np.zeros(8)])
def test_f64_input_shape_raises_as_in_jax(vs):
    _raises_alike(lambda: ft.DatabaseBuilder(vs, np.float64, device="cpu"),
                  lambda: fdb.DatabaseBuilder(vs, dtype=np.float64),
                  "f64 build")


def _tree(base: Path) -> dict:
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_f64_seam_round_trip_matches_the_jax_tree(tmp_path):
    """The port's counterpart of the JAX package's
    ``test_builder_f64_dtype_seam``: build -> set_attribute_at -> save ->
    load -> query, with the tree byte-equal to the JAX package's."""
    x = _x(3)
    ours, theirs = _pair(x)
    db, jdb = ours.build(), theirs.build()
    db.set_attribute_at(0, ("tag", 7))
    jdb.set_attribute_at(0, ("tag", 7))
    root = ft.save_database(db, ft.LocalFileSystem(tmp_path / "port"))
    jroot = fdb.save_database(jdb, fdb.LocalFileSystem(tmp_path / "jax"))
    assert root == jroot
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")

    sdb = ft.load_database(ft.LocalFileSystem(tmp_path / "port"),
                           f"{root}.binpb", device="cpu")
    got = sdb.query(x[0].astype(np.float32), k=5, nprobe=4)
    assert len(got) == 5
    assert got[0].vector_id == db.vector_ids[0]
    assert got[0].get_attribute("tag") == 7
    want = jdb.query(x[0].astype(np.float32), k=5, nprobe=4)
    assert [r.vector_id for r in got] == [r.vector_id for r in want]
    for g, w in zip(got, want):
        assert g.squared_distance == pytest.approx(w.squared_distance,
                                                   rel=1e-4, abs=1e-5)
    sdb.preload()
    warm = sdb.query_batch(x[:3].astype(np.float32), k=5, nprobe=4)
    assert [r.vector_id for r in warm[0]] == [r.vector_id for r in got]


def test_f64_database_serves_on_the_cpu_path():
    x = _x(8, 500, 16)
    db = _pair(x, p=6, d=4, c=16)[0].build()
    res = db.query_batch(x[:20].astype(np.float32), k=3, nprobe=6)
    assert sum(r[0].vector_id == db.vector_ids[i]
               for i, r in enumerate(res)) >= 19
    mine = db.query(x[1], k=3, nprobe=6)
    assert mine[0].vector_id == db.vector_ids[1]
