"""The port's streaming build (``flechasdb_tpu_torch/streaming.py``) held
against the JAX package's ``StreamingDatabaseBuilder`` on the CPU: the
same vector ids and the same reads of the source for a seed, recall
within noise, codes equal to the JAX package's encode of the port's own
trained arrays up to near-ties, the same events, errors and saved bytes.
"""

import os

import jax
import numpy as np
import pytest

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu.ops.encode import encode as jax_encode
from flechasdb_tpu.streaming import \
    StreamingDatabaseBuilder as JaxStreaming
from flechasdb_tpu_torch import events as pev
from flechasdb_tpu_torch import streaming
from flechasdb_tpu_torch.streaming import StreamingDatabaseBuilder

from _torch_helpers import event_pattern, world_of_one  # noqa: F401

TIE_REL = 1e-5


class TrackingSource:
    """An array that records every read: ``("rows", first, last, count)``
    for a fancy read, ``("slice", lo, hi)`` for a contiguous one."""

    def __init__(self, x, slices_only=False):
        self._x = x
        self.shape = x.shape
        self.reads = []
        self._slices_only = slices_only

    def __getitem__(self, key):
        if isinstance(key, slice):
            self.reads.append(("slice", key.start, key.stop))
        elif self._slices_only:
            raise TypeError("slices only")
        else:
            rows = np.asarray(key)
            assert (np.diff(rows) > 0).all()          # sorted, unique
            self.reads.append(("rows", int(rows[0]), int(rows[-1]),
                               len(rows)))
        return self._x[key]


def _lowdim(rng, w, n):
    z = rng.standard_normal((n, w.shape[0])).astype(np.float32)
    noise = 0.05 * rng.standard_normal((n, w.shape[1])).astype(np.float32)
    return (z @ w + noise).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    x = _lowdim(rng, w, 6000)
    q = _lowdim(rng, w, 50)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d, axis=1, kind="stable")[:, :10]


def _recall(db, q, gt):
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    res = db.query_batch(q, k=10, nprobe=4)
    return float(np.mean([len({row_of[r.vector_id] for r in rs}
                              & set(gt[b].tolist())) / 10
                          for b, rs in enumerate(res)]))


def _configure(builder, **caps):
    b = (builder.with_partitions(16).with_divisions(4).with_clusters(32)
         .with_seed(7))
    if caps:
        b = b.with_training_caps(**caps)
    return b.with_chunk_rows(512)


CAPS = dict(coarse_cap=2048, pq_cap=2048)


@pytest.fixture(scope="module")
def both(corpus):
    """The port's and the JAX package's streamed builds of one tracked
    corpus, caps and chunks engaged."""
    x = corpus[0]
    mine_src, theirs_src = TrackingSource(x), TrackingSource(x)
    mine = _configure(StreamingDatabaseBuilder(mine_src, device="cpu"),
                      **CAPS).build()
    theirs = _configure(JaxStreaming(theirs_src), **CAPS).build()
    return mine, theirs, mine_src, theirs_src


def test_same_ids_and_reads_as_jax(both):
    mine, theirs, mine_src, theirs_src = both
    assert mine.vector_ids == list(theirs.vector_ids)
    assert mine_src.reads == theirs_src.reads
    first = mine_src.reads[0]
    assert first[0] == "rows" and first[3] == CAPS["coarse_cap"]
    assert [r for r in mine_src.reads[1:]] == [
        ("slice", lo, min(lo + 512, 6000)) for lo in range(0, 6000, 512)]
    assert mine.residues is None and mine.rotation is None
    assert mine.codes.dtype == np.uint32 and mine.codes.shape == (6000, 4)
    assert mine.partition_indices.dtype == np.int32


def test_recall_within_noise_of_jax_and_the_in_memory_build(both, corpus):
    mine, theirs, _, _ = both
    x, q, gt = corpus
    ref = (ft.DatabaseBuilder(x, device="cpu").with_partitions(16)
           .with_divisions(4).with_clusters(32).with_seed(7).build())
    r_mine, r_theirs, r_mem = (_recall(mine, q, gt), _recall(theirs, q, gt),
                               _recall(ref, q, gt))
    assert abs(r_mine - r_theirs) <= 0.05, (r_mine, r_theirs)
    assert r_mine > r_mem - 0.05, (r_mine, r_mem)


def test_codes_are_the_jax_encode_of_the_ports_arrays(both, corpus):
    mine = both[0]
    x = corpus[0]
    pidx, codes = (np.asarray(a).astype(np.int64) for a in jax_encode(
        jax.numpy.asarray(x), jax.numpy.asarray(mine.partition_centroids),
        jax.numpy.asarray(mine.codebooks)))
    cents = mine.partition_centroids.astype(np.float64)
    x64 = x.astype(np.float64)
    got_p = mine.partition_indices.astype(np.int64)

    def dist(pick):
        return ((x64 - cents[pick]) ** 2).sum(-1)

    scale = (x64 ** 2).sum(-1) + (cents ** 2).sum(-1).max()
    assert not ((got_p != pidx) & (np.abs(dist(got_p) - dist(pidx))
                                   > TIE_REL * scale)).any()
    same = got_p == pidx
    r = (x64 - cents[got_p]).reshape(len(x), 4, -1)[same]
    books = mine.codebooks.astype(np.float64)
    dd = np.arange(4)[None, :]

    def cdist(code):
        return ((r - books[dd, code]) ** 2).sum(-1)

    got_c = mine.codes.astype(np.int64)[same]
    want_c = codes[same]
    cscale = (r ** 2).sum(-1) + (books ** 2).sum(-1).max()
    assert not ((got_c != want_c) & (np.abs(cdist(got_c) - cdist(want_c))
                                     > TIE_REL * cscale)).any()
    assert same.mean() > 0.99


def test_memmap_and_slice_only_sources_build_the_same_database(corpus,
                                                               tmp_path):
    x = corpus[0][:1500]
    mm = np.lib.format.open_memmap(tmp_path / "corpus.npy", mode="w+",
                                   dtype=np.float32, shape=x.shape)
    mm[:] = x
    mm.flush()
    sliced = TrackingSource(x, slices_only=True)

    def build(src):
        return (StreamingDatabaseBuilder(src, device="cpu")
                .with_partitions(8).with_divisions(4).with_clusters(16)
                .with_seed(9).with_training_caps(coarse_cap=600, pq_cap=600)
                .with_chunk_rows(256).build())

    want = build(x)
    for got in (build(mm), build(sliced)):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.partition_indices,
                                      want.partition_indices)
        np.testing.assert_array_equal(got.partition_centroids,
                                      want.partition_centroids)
    assert all(r[0] == "slice" for r in sliced.reads)
    assert streaming._gather_rows(sliced, np.array([0, 1, 2, 5, 9]), 32) \
        .tolist() == x[[0, 1, 2, 5, 9]].tolist()


def test_events_deterministic_for_a_seed(corpus):
    x = corpus[0][:1200]

    def build(cls, handler, **kw):
        return (cls(x, **kw).with_partitions(8).with_divisions(4)
                .with_clusters(16).with_seed(21).with_chunk_rows(500)
                .build_with_events(handler))

    mine, theirs = [], []
    db1 = build(StreamingDatabaseBuilder, mine.append, device="cpu")
    db2 = build(StreamingDatabaseBuilder, lambda e: None, device="cpu")
    build(JaxStreaming, theirs.append)
    assert db1.vector_ids == db2.vector_ids
    np.testing.assert_array_equal(db1.codes, db2.codes)
    np.testing.assert_array_equal(db1.partition_centroids,
                                  db2.partition_centroids)
    assert event_pattern(mine) == event_pattern(theirs)
    assert any(isinstance(e, pev.ClusterEvent) for e in mine)
    assert event_pattern(mine)[:4] == ["StartingIdAssignment",
                                  "FinishedIdAssignment",
                                  "StartingPartitioning",
                                  "cluster:StartingCentroidInitialization"]


def test_opq_rotation_is_orthogonal(corpus):
    x, q, gt = corpus
    db = (StreamingDatabaseBuilder(x, device="cpu").with_partitions(16)
          .with_divisions(4).with_clusters(32).with_seed(7).with_opq(iters=2)
          .with_training_caps(coarse_cap=2048, pq_cap=2048)
          .with_chunk_rows(2000).build())
    assert db.rotation is not None and db.rotation.shape == (32, 32)
    np.testing.assert_allclose(db.rotation @ db.rotation.T, np.eye(32),
                               atol=1e-4)
    assert _recall(db, q, gt) > 0.4


def test_cosine_normalizes_and_a_zero_row_raises_the_jax_text(corpus):
    x = corpus[0][:1500] * 3.0
    db = (StreamingDatabaseBuilder(x, device="cpu").with_metric("cosine")
          .with_partitions(8).with_divisions(4).with_clusters(16)
          .with_seed(2).with_chunk_rows(400).build())
    assert db.metric == "cosine"
    # Means of unit rows: inside the unit ball.
    assert (np.linalg.norm(db.partition_centroids, axis=1) <= 1 + 1e-5).all()
    top = db.query(x[10], k=1, nprobe=8)[0]
    assert top.vector_id == db.vector_ids[10]
    bad = x.copy()
    bad[1400] = 0.0       # streams past in the last chunk, not the sample

    def build(cls, **kw):
        return (cls(bad, **kw).with_metric("cosine").with_partitions(8)
                .with_divisions(4).with_clusters(16).with_seed(2)
                .with_training_caps(coarse_cap=100, pq_cap=100)
                .with_chunk_rows(400).build())

    with pytest.raises(ft.InvalidArgs) as mine:
        build(StreamingDatabaseBuilder, device="cpu")
    with pytest.raises(fdb.InvalidArgs) as theirs:
        build(JaxStreaming)
    assert str(mine.value) == str(theirs.value)


def _error_calls(cls, **kw):
    x = np.zeros((10, 8), np.float32)
    return [
        lambda: cls(np.zeros((0, 8), np.float32), **kw),
        lambda: cls(x, **kw).with_partitions(0),
        lambda: cls(x, **kw).with_divisions(0),
        lambda: cls(x, **kw).with_clusters(0),
        lambda: cls(x, **kw).with_opq(0),
        lambda: cls(x, **kw).with_chunk_rows(0),
        lambda: cls(x, **kw).with_training_caps(coarse_cap=0),
        lambda: cls(x, **kw).with_training_caps(pq_cap=-1),
        lambda: cls(x, **kw).with_training_caps(sample_bytes=0),
        lambda: cls(x, **kw).with_metric("manhattan"),
        lambda: cls(x, **kw).with_divisions(3).with_clusters(4)
        .with_partitions(2).build(),
        lambda: cls(x, **kw).with_partitions(11).build(),
        lambda: cls(x, **kw).with_partitions(2).with_clusters(11).build(),
    ]


@pytest.mark.parametrize("case", range(13))
def test_errors_carry_the_jax_messages(case):
    mine = _error_calls(StreamingDatabaseBuilder, device="cpu")[case]
    theirs = _error_calls(JaxStreaming)[case]
    with pytest.raises(ft.InvalidArgs) as got:
        mine()
    with pytest.raises(fdb.InvalidArgs) as want:
        theirs()
    assert str(got.value) == str(want.value)


def test_floor_tight_caps_still_train():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20000, 8)).astype(np.float32)
    db = (StreamingDatabaseBuilder(x, device="cpu").with_partitions(1024)
          .with_divisions(2).with_clusters(16).with_seed(5)
          .with_training_caps(sample_bytes=1).build())
    assert db.num_partitions == 1024 and len(db.vector_ids) == 20000
    y = rng.standard_normal((24, 4)).astype(np.float32)
    db2 = (StreamingDatabaseBuilder(y, device="cpu").with_partitions(2)
           .with_divisions(2).with_clusters(16).with_seed(5)
           .with_training_caps(coarse_cap=16, pq_cap=16).build())
    assert len(db2.vector_ids) == 24


def _files(base):
    return {os.path.relpath(os.path.join(d, f), base):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(base) for f in fs}


def test_save_is_byte_equal_to_jax_and_loads_in_both(both, corpus,
                                                     tmp_path):
    mine = both[0]
    x = corpus[0]
    jdb = fdb.build.Database(**ft.to_arrays(mine))
    root = ft.save_database(mine, ft.LocalFileSystem(tmp_path / "port"))
    assert fdb.save_database(jdb, fdb.LocalFileSystem(tmp_path / "jax")) \
        == root
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    want = mine.query(x[5], k=5, nprobe=8)
    port = ft.load_database(ft.LocalFileSystem(tmp_path / "jax"),
                            f"{root}.binpb", device="cpu")
    theirs = fdb.load_database(fdb.LocalFileSystem(tmp_path / "port"),
                               f"{root}.binpb")
    for sdb in (port, theirs):
        got = sdb.query(x[5], k=5, nprobe=8)
        assert [r.vector_id for r in got] == [r.vector_id for r in want]


def test_streamed_build_sharded_encode_matches(world_of_one):
    """``with_mesh`` (``tests/test_streaming.py:255-278``): partition
    indices and codes bit-identical to the unsharded streamed build of the
    same seed, the same ids, and a database that serves like it; with OPQ
    too, whose rotation is broadcast."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3000, 32)).astype(np.float32)

    def build(mesh, opq=0):
        b = (StreamingDatabaseBuilder(x, device="cpu").with_partitions(16)
             .with_divisions(4).with_clusters(16).with_seed(11)
             .with_chunk_rows(700))       # 5 chunks, the last one padded
        if opq:
            b = b.with_opq(opq)
        if mesh is not None:
            b = b.with_mesh(mesh)
        return b.build()

    for opq in (0, 2):
        base, sharded = build(None, opq), build(world_of_one, opq)
        np.testing.assert_array_equal(base.partition_indices,
                                      sharded.partition_indices)
        np.testing.assert_array_equal(base.codes, sharded.codes)
        assert base.vector_ids == sharded.vector_ids
        if opq:
            np.testing.assert_array_equal(base.rotation, sharded.rotation)
        got = sharded.query(x[5], k=3, nprobe=16)
        want = base.query(x[5], k=3, nprobe=16)
        assert [r.vector_id for r in got] == [r.vector_id for r in want]
