"""The port's fsspec object store (``flechasdb_tpu_torch/objectstore.py``)
against the JAX package's, over ``file://`` and ``memory://``.

Both packages save the same database through their object stores: the
roots and objects must be equal, and cold queries through either store
equal to the bit. The port's copy names a local write's temporary file per
writer; the test of two threads saving one object at once holds that
repair, and shows the JAX package's PID-only name failing under the same
schedule.
"""

import asyncio
import threading
import uuid

import numpy as np
import pytest

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import objectstore as jobjectstore
from flechasdb_tpu.memfs import MemoryFileSystem as JMemoryFileSystem
from flechasdb_tpu_torch import asyncdb as pasync
from flechasdb_tpu_torch import objectstore
from flechasdb_tpu_torch.asyncdb.io import AsyncStreamingHashedFileReader

fsspec = pytest.importorskip("fsspec")


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    jdb = (fdb.DatabaseBuilder(x).with_partitions(6).with_divisions(4)
           .with_clusters(8).with_seed(1).build())
    for i in range(0, 300, 3):
        jdb.set_attribute_at(i, ("datum_id", i))
    return x, jdb, ft.from_jax_arrays(jdb, device="cpu")


def _fields(results):
    return [(r.vector_id, r.partition_index, r.vector_index,
             r.squared_distance) for r in results]


def _url(proto, tmp_path, tag):
    return (f"file://{tmp_path / tag}" if proto == "file"
            else f"memory://fdbt-{tag}-{uuid.uuid4().hex}")


@pytest.mark.parametrize("proto", ["file", "memory"])
def test_save_load_query_round_trip_matches_jax(dbs, tmp_path, proto):
    x, jdb, pdb = dbs
    mine = ft.FsspecFileSystem(_url(proto, tmp_path, "port"))
    theirs = fdb.FsspecFileSystem(_url(proto, tmp_path, "jax"))
    root = ft.save_database(pdb, mine)
    assert fdb.save_database(jdb, theirs) == root

    def objects(store):
        return {p[len(store.base_path) + 1:]: store.fs.cat_file(p)
                for p in store.fs.find(store.base_path)}

    assert objects(mine) == objects(theirs)
    sdb = ft.load_database(mine, f"{root}.binpb", device="cpu")
    jsdb = fdb.load_database(theirs, f"{root}.binpb")
    for v in x[[9, 50, 123]]:
        got, want = sdb.query(v, 5, 6), jsdb.query(v, 5, 6)
        assert _fields(got) == _fields(want)
        assert got[0].get_attribute("datum_id") == \
            want[0].get_attribute("datum_id")
    # named files: labels on the object store
    ft.publish_label(mine, root)
    assert ft.resolve_label(mine) == root
    assert mine.exists(f"{root}.binpb") and not mine.exists("nope.binpb")


def test_async_fsspec_matches_the_sync_tier(dbs, tmp_path):
    x, _, pdb = dbs
    url = f"file://{tmp_path}"
    root = ft.save_database(pdb, ft.FsspecFileSystem(url))
    sync = ft.load_database(ft.FsspecFileSystem(url), f"{root}.binpb",
                            device="cpu")

    async def run():
        adb = await pasync.load_database(ft.AsyncFsspecFileSystem(url),
                                         f"{root}.binpb")
        return [_fields(await adb.query(v, 5, 6)) for v in x[[9, 77]]]

    assert asyncio.run(run()) == [_fields(sync.query(v, 5, 6))
                                  for v in x[[9, 77]]]


def test_async_save_onto_the_object_store(dbs):
    x, jdb, pdb = dbs
    url = f"memory://fdbt-asave-{uuid.uuid4().hex}"
    root = asyncio.run(pasync.save_database(pdb, ft.FsspecFileSystem(url),
                                            max_concurrency=8))
    assert root == fdb.save_database(jdb, JMemoryFileSystem())

    async def run():
        adb = await pasync.load_database(ft.AsyncFsspecFileSystem(url),
                                         f"{root}.binpb")
        return await adb.query(x[0], 3, 6)

    assert asyncio.run(run())[0].vector_id == pdb.vector_ids[0]


def test_missing_object_is_ioerror(tmp_path):
    fs = ft.FsspecFileSystem(f"file://{tmp_path}")
    with pytest.raises(ft.IOError_):
        fs.open_hashed_file("nope.binpb")
    with pytest.raises(ft.IOError_):
        fs.read_named("labels/nope")

    async def run():
        await ft.AsyncFsspecFileSystem(f"file://{tmp_path}").open_hashed_file(
            "nope.binpb")

    with pytest.raises(ft.IOError_):
        asyncio.run(run())


def test_crash_leaves_no_final_file(tmp_path, monkeypatch):
    """file protocol: a write goes to a temporary name, then moves — a
    finished artifact under its hash name is always complete, and a write
    that fails leaves nothing under the final name."""
    fs = ft.FsspecFileSystem(f"file://{tmp_path}")
    f = fs.create_hashed_file(compress=True)
    f.write(b"payload")
    h = f.persist("binpb")
    assert [p.name for p in tmp_path.iterdir()] == [f"{h}.binpb"]

    class Crash(Exception):
        pass

    def crash(*args, **kwargs):
        raise Crash

    monkeypatch.setattr(fs.fs, "mv", crash)
    g = fs.create_hashed_file(compress=True)
    g.write(b"other payload")
    with pytest.raises(Crash):
        g.persist("binpb")
    monkeypatch.undo()
    assert f"{h}.binpb" in [p.name for p in tmp_path.iterdir()]
    assert [p.name for p in tmp_path.iterdir()
            if p.name.endswith(".binpb")] == [f"{h}.binpb"]


def test_streaming_reader_serves_the_whole_database(dbs, tmp_path):
    """``streaming_threshold=0`` forces the incremental reader on every
    artifact; the whole async path must still load, verify and query."""
    x, _, pdb = dbs
    root = ft.save_database(pdb, ft.LocalFileSystem(tmp_path))
    sync = ft.load_database(ft.LocalFileSystem(tmp_path), f"{root}.binpb",
                            device="cpu")

    async def run():
        fs = pasync.AsyncLocalFileSystem(tmp_path, streaming_threshold=0)
        f = await fs.open_hashed_file(f"{root}.binpb", compressed=True)
        assert isinstance(f, AsyncStreamingHashedFileReader)
        with pytest.raises(ft.IOError_):
            f.verify()                      # before read: nothing hashed
        adb = await pasync.load_database(fs, f"{root}.binpb")
        return await adb.query(x[9], 5, 6)

    assert _fields(asyncio.run(run())) == _fields(sync.query(x[9], 5, 6))


def test_streaming_reader_detects_corruption(dbs, tmp_path):
    x, _, pdb = dbs
    root = ft.save_database(pdb, ft.LocalFileSystem(tmp_path))
    target = tmp_path / f"{root}.binpb"
    raw = bytearray(target.read_bytes())
    raw[1] = 0xDA                 # zlib level hint: inflates the same
    target.write_bytes(bytes(raw))

    async def run():
        fs = pasync.AsyncLocalFileSystem(tmp_path, streaming_threshold=0)
        f = await fs.open_hashed_file(f"{root}.binpb", compressed=True)
        await f.read()
        f.verify()

    with pytest.raises(ft.VerificationFailure):
        asyncio.run(run())


class _Rendezvous:
    """An fsspec filesystem whose temporary writes wait for each other:
    both writers have written their temporary file before either moves
    it. Everything else is the wrapped filesystem's."""

    def __init__(self, fs, parties: int) -> None:
        self._fs = fs
        self._barrier = threading.Barrier(parties, timeout=30)

    def __getattr__(self, name):
        return getattr(self._fs, name)

    def pipe_file(self, path, value, **kwargs):
        self._fs.pipe_file(path, value, **kwargs)
        self._barrier.wait()


def _persist_twice(store_cls, tmp_path, payload):
    store = store_cls(_Rendezvous(fsspec.filesystem("file"), 2),
                      str(tmp_path))
    errors, names = [], []

    def save():
        try:
            f = store.create_hashed_file("chunks", compress=True)
            f.write(payload)
            names.append(f.persist("binpb"))
        except Exception as e:          # reported to the test below
            errors.append(e)

    threads = [threading.Thread(target=save) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return errors, names


def test_two_threads_persist_one_object_at_once(tmp_path):
    payload = b"the same artifact " * 512
    errors, names = _persist_twice(ft.FsspecFileSystem, tmp_path, payload)
    assert errors == [] and len(names) == 2 and names[0] == names[1]
    files = sorted(p.name for p in (tmp_path / "chunks").iterdir())
    assert files == [f"{names[0]}.binpb"]          # no temporary left
    f = ft.FsspecFileSystem(f"file://{tmp_path}").open_hashed_file(
        f"chunks/{files[0]}", compressed=True)
    assert f.read() == payload
    f.verify()
    assert objectstore._tmp_name("a/b") != objectstore._tmp_name("a/b")


def test_the_jax_pid_only_name_fails_under_the_same_schedule(tmp_path):
    """The fault the port's copy repairs (``objectstore.py:91``): both
    threads write one temporary file, the first move takes it, the second
    finds nothing to move."""
    errors, names = _persist_twice(jobjectstore.FsspecFileSystem, tmp_path,
                                   b"the same artifact " * 512)
    assert len(names) == 1 and len(errors) == 1
    assert isinstance(errors[0], fdb.IOError_)
