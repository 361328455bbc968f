"""The checked-in trees load through the port and give the results that
``tests/test_golden.py``, ``test_golden_refdb.py`` and
``test_golden_ext.py`` check for the JAX package.

``goldendb`` was written by the JAX package's serializer, ``refdb`` by an
independent writer (protoc codec, stdlib zlib and hashlib), ``extgolden``
with the extension fields (metric ``dot`` and an OPQ rotation). The port
reads all three without jax; cold queries on the host give the recorded
results, and so do ``goldendb`` and ``extgolden`` (its rotation on the
device, through the dot tables) served from the port's device index
after ``preload``.
"""

import json
import uuid
from pathlib import Path

import numpy as np
import pytest

import flechasdb_tpu_torch as ft

FIXTURES = Path(__file__).parent / "fixtures"


def _expected(name):
    return [line.split(",") for line in
            (FIXTURES / f"{name}_expected.txt").read_text().splitlines()]


def _load(name, root):
    return ft.load_database(ft.LocalFileSystem(FIXTURES / name),
                            f"{root}.binpb", device="cpu")


def _check(res, expected):
    assert len(res) == len(expected)
    for r, (vid, pi, vi, dist) in zip(res, expected):
        assert r.vector_id == uuid.UUID(vid)
        assert r.partition_index == int(pi)
        assert r.vector_index == int(vi)
        assert r.squared_distance == pytest.approx(float(dist), abs=1e-4)


@pytest.fixture
def golden():
    root = (FIXTURES / "goldendb_root.txt").read_text().strip()
    x = np.load(FIXTURES / "goldendb_vectors.npy")
    return _load("goldendb", root), x, root


def test_goldendb_loads_and_validates(golden):
    db, _, _ = golden
    assert (db.vector_size, db.num_partitions, db.num_divisions,
            db.num_codes) == (16, 4, 4, 8)
    assert db.attribute_names == ["datum_id", "label"]
    assert db.metric == "l2"


@pytest.mark.parametrize("warm", [False, True])
def test_goldendb_query_matches_recorded_results(golden, warm):
    db, x, _ = golden
    if warm:
        db.preload()
    res = db.query(x[10], k=5, nprobe=4)
    _check(res, _expected("goldendb"))
    for r in res:
        datum, label = r.get_attribute("datum_id"), r.get_attribute("label")
        if datum is not None:
            assert datum % 2 == 0 and label == f"even-{datum}"
    if warm:
        batch = db.query_batch(x[10:11], k=5, nprobe=4)[0]
        assert [r.vector_id for r in batch] == [r.vector_id for r in res]


def test_goldendb_resaves_to_its_own_tree(golden, tmp_path):
    db, _, root = golden
    mem = db.to_database()
    assert ft.save_database(mem, ft.LocalFileSystem(tmp_path)) == root
    src = {p.relative_to(FIXTURES / "goldendb").as_posix(): p.read_bytes()
           for p in (FIXTURES / "goldendb").rglob("*.binpb")}
    dst = {p.relative_to(tmp_path).as_posix(): p.read_bytes()
           for p in tmp_path.rglob("*.binpb")}
    assert dst == src


def _refdb_meta():
    z = np.load(FIXTURES / "refdb_meta.npz", allow_pickle=True)
    return dict(centroids=z["centroids"], codebooks=z["codebooks"],
                codes=z["codes"],
                vids=[uuid.UUID(int=int(u)) for u in z["vids"]],
                members=[z["members0"].tolist(), z["members1"].tolist()])


def _refdb_oracle(v, t, k, nprobe, sub=2, d=4):
    """ADC k-NN straight from the raw arrays (``db/build.rs:521-565``)."""
    coarse = ((v[None] - t["centroids"]) ** 2).sum(-1)
    out = []
    for pi in np.argsort(coarse, kind="stable")[:nprobe]:
        resid = (v - t["centroids"][pi]).reshape(d, sub)
        table = ((resid[:, None, :] - t["codebooks"]) ** 2).sum(-1)
        for i in t["members"][pi]:
            out.append((float(table[np.arange(d), t["codes"][i]].sum()),
                        t["vids"][i]))
    out.sort(key=lambda r: r[0])
    return out[:k]


@pytest.mark.parametrize("warm", [False, True])
def test_refdb_query_and_attributes(warm):
    t = _refdb_meta()
    root = json.loads((FIXTURES / "refdb_root.json").read_text())["root"]
    db = _load("refdb", root)
    assert db.vector_size == 8 and db.num_partitions == 2
    db.verify_all = True
    if warm:
        db.preload()
    rng = np.random.default_rng(13)
    for _ in range(3):
        v = rng.standard_normal(8).astype(np.float32)
        got = db.query(v, k=5, nprobe=2)
        want = _refdb_oracle(v, t, k=5, nprobe=2)
        assert [r.vector_id for r in got] == [w[1] for w in want]
        np.testing.assert_allclose([r.squared_distance for r in got],
                                   [w[0] for w in want], rtol=1e-4,
                                   atol=1e-5)
    i = t["vids"].index(got[0].vector_id)
    assert got[0].get_attribute("datum_id") == i
    assert got[0].get_attribute("label") == (f"v{i}" if i % 2 == 0
                                             else None)


@pytest.fixture
def extgolden():
    root = (FIXTURES / "extgolden_root.txt").read_text().strip()
    return _load("extgolden", root), np.load(FIXTURES / "extgolden_query.npy")


def test_extgolden_queries_cold_with_its_rotation(extgolden):
    db, q = extgolden
    assert db.metric == "dot"
    rot = db._load_rotation()
    assert rot is not None and rot.shape == (16, 16)
    np.testing.assert_allclose(rot @ rot.T, np.eye(16), atol=1e-5)
    res = db.query(q, k=4, nprobe=db.num_partitions)
    _check(res, _expected("extgolden"))
    assert all(r.squared_distance < 0 for r in res)
    vid0 = uuid.UUID("12345678-90ab-cdef-0000-000000000001")
    pi = next(i for i in range(db.num_partitions)
              if vid0 in db.get_partition(i).vector_ids)
    assert db._get_attribute_in_partition(pi, vid0, "name") == "zero"


def test_extgolden_device_path_names_item_13(extgolden):
    """The device path carries the stored rotation: ``preload`` serves the
    recorded results, equal to the cold path's; ``to_database`` and
    ``query_batch`` carry the rotation too."""
    db, q = extgolden
    nprobe = db.num_partitions
    cold = db.query(q, k=4, nprobe=nprobe)
    _check(cold, _expected("extgolden"))
    mem = db.to_database()
    np.testing.assert_array_equal(mem.rotation, db._load_rotation())
    _check(mem.query(q, k=4, nprobe=nprobe), _expected("extgolden"))
    db.preload()
    assert db._dev is not None and db._dev[0].rotation is not None
    warm = db.query(q, k=4, nprobe=nprobe)
    _check(warm, _expected("extgolden"))
    assert [r.vector_id for r in warm] == [r.vector_id for r in cold]
    np.testing.assert_allclose([r.squared_distance for r in warm],
                               [r.squared_distance for r in cold],
                               rtol=1e-4, atol=1e-5)
    batch, = db.query_batch(q[None], k=4, nprobe=nprobe)
    assert [r.vector_id for r in batch] == [r.vector_id for r in cold]
