"""The port's content store against the JAX package's: ``content_hash``,
the hashed writer and reader, ``LocalFileSystem``, ``MemoryFileSystem``
and the native IO runtime (``flechasdb_tpu_torch/_native.py`` over its
copy of ``native/fastio.cc``).

The same payloads, made from a numpy seed, go through both packages; the
stored bytes, names and error messages must be equal. The port's native
route and its Python route (zlib, hashlib, numpy) must give the same
bytes, as ``tests/test_native.py`` holds them for the JAX package.
"""

import os
import time
import zlib

import numpy as np
import pytest

from flechasdb_tpu import _native as j_native
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import io as jio
from flechasdb_tpu import memfs as jmemfs
from flechasdb_tpu_torch import _native, errors, io, memfs
from flechasdb_tpu_torch import stored


def _payload(size: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    # half random, half repetitive: deflate has work to do either way
    half = rng.bytes(size // 2)
    return half + bytes(size - len(half))


def _persisted(mod, data: bytes, compress: bool):
    out = {}
    w = mod.HashedFileWriter(lambda b, name: out.update({name: b}), compress)
    w.write(data[:len(data) // 3])
    w.write(data[len(data) // 3:])
    h = w.persist()
    return h, out


@pytest.mark.parametrize("size", [0, 1, 55, 56, 64, 65, 4096, 1 << 20])
def test_content_hash_matches_jax(size):
    data = _payload(size, size)
    assert io.content_hash(data) == jio.content_hash(data)


@pytest.mark.parametrize("size", [0, 100, 70_000])
@pytest.mark.parametrize("compress", [False, True])
def test_writer_and_reader_match_jax(size, compress):
    data = _payload(size, 7)
    got, want = _persisted(io, data, compress), _persisted(jio, data,
                                                           compress)
    assert got == want
    h, files = got
    (name, stored_bytes), = files.items()
    assert name == f"{h}.binpb"
    for mod in (io, jio):
        r = mod.HashedFileReader(stored_bytes, name, compress)
        assert r.read() == data
        r.verify()
    with pytest.raises(errors.IOError_, match="already persisted"):
        w = io.HashedFileWriter(lambda b, n: None, compress)
        w.persist()
        w.persist()


@pytest.mark.parametrize("native", [True, False])
def test_python_route_gives_the_native_bytes(native, monkeypatch):
    """Every file the port writes has the same bytes and name on both
    routes; a reader on either route reads and verifies the other's."""
    data = _payload(50_000, 3)
    assert _native.available()
    packed = {c: _persisted(io, data, c) for c in (False, True)}
    if not native:
        monkeypatch.setattr(_native, "_load", lambda: None)
        assert not _native.available()
        assert {c: _persisted(io, data, c) for c in (False, True)} == packed
    assert packed[True][1][f"{packed[True][0]}.binpb"] == zlib.compress(
        data, 6)
    for compress, (h, files) in packed.items():
        r = io.HashedFileReader(files[f"{h}.binpb"], f"{h}.binpb", compress)
        assert r.read(need_hash=False) == data
        r.verify()


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("compress", [False, True])
def test_flipped_byte_raises_verification_failure(route, compress,
                                                  monkeypatch):
    data = _payload(5000, 11)
    if route == "python":
        monkeypatch.setattr(_native, "_load", lambda: None)
        monkeypatch.setattr(j_native, "_load", lambda: None)
    h, files = _persisted(io, data, compress)
    raw = bytearray(files[f"{h}.binpb"])
    raw[len(raw) // 2] ^= 0x01
    msgs = []
    for mod, err in ((io, errors), (jio, jerrors)):
        r = mod.HashedFileReader(bytes(raw), f"{h}.binpb", compress)
        try:
            r.read()
        except err.IOError_:
            pass        # a flip inside the deflate stream may break it
        with pytest.raises(err.VerificationFailure) as e:
            r.verify()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("route", ["native", "python"])
def test_bad_zlib_raises_the_jax_message(route, monkeypatch):
    if route == "python":
        monkeypatch.setattr(_native, "_load", lambda: None)
        monkeypatch.setattr(j_native, "_load", lambda: None)
    bad = zlib.compress(_payload(1000, 5))[:-3] + b"xyz"
    msgs = []
    for mod, err in ((io, errors), (jio, jerrors)):
        with pytest.raises(err.IOError_) as e:
            mod.HashedFileReader(bad, "x.binpb", True).read()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("zlib decompression failed: ")


def _tree(tmp):
    return {os.path.relpath(os.path.join(d, f), tmp):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(tmp) for f in fs}


def test_local_file_system_matches_jax(tmp_path):
    trees = []
    for mod, sub in ((io, "port"), (jio, "jax")):
        fs = mod.LocalFileSystem(tmp_path / sub)
        names = []
        for i, (subdir, compress) in enumerate(
                [("", True), ("partitions", True), ("codebooks", False),
                 ("partitions", False)]):
            w = fs.create_hashed_file(subdir, compress=compress)
            w.write(_payload(3000 + i, i))
            names.append((subdir, w.persist()))
        fs.write_named("labels/latest", b"abc\n")
        assert fs.read_named("labels/latest") == b"abc\n"
        assert fs.exists(f"{names[0][1]}.binpb")
        assert not fs.exists("nothing.binpb")
        r = fs.open_hashed_file(f"partitions/{names[1][1]}.binpb",
                                compressed=True)
        assert r.read() == _payload(3001, 1)
        r.verify()
        trees.append((names, _tree(tmp_path / sub)))
    assert trees[0] == trees[1]
    with pytest.raises(errors.IOError_):
        io.LocalFileSystem(tmp_path / "port").open_hashed_file("missing")
    with pytest.raises(errors.IOError_):
        io.LocalFileSystem(tmp_path / "port").read_named("labels/none")


def test_local_file_system_skips_an_existing_file(tmp_path):
    """A name already stored with the payload's size is not rewritten; a
    short file under the name is."""
    fs = io.LocalFileSystem(tmp_path)
    data = _payload(4000, 2)
    w = fs.create_hashed_file("partitions", compress=True)
    w.write(data)
    h = w.persist()
    path = tmp_path / "partitions" / f"{h}.binpb"
    before = path.stat().st_mtime_ns
    time.sleep(0.01)
    w = fs.create_hashed_file("partitions", compress=True)
    w.write(data)
    assert w.persist() == h
    assert path.stat().st_mtime_ns == before
    full = path.read_bytes()
    path.write_bytes(full[:10])
    w = fs.create_hashed_file("partitions", compress=True)
    w.write(data)
    w.persist()
    assert path.read_bytes() == full
    assert sorted(os.listdir(tmp_path / "partitions")) == [f"{h}.binpb"]


def test_memory_file_system_matches_jax():
    got, want = memfs.MemoryFileSystem(), jmemfs.MemoryFileSystem()
    for fs in (got, want):
        for i, (subdir, compress) in enumerate(
                [("", True), ("attributes", True), ("codebooks", False)]):
            w = fs.create_hashed_file(subdir, compress=compress)
            w.write(_payload(2000 + i, 20 + i))
            w.persist()
        fs.write_named("labels/x", b"root\n")
    assert got.objects == want.objects
    name = next(k for k in got.objects if k.startswith("attributes/"))
    assert got.exists(name) and not got.exists("attributes/none.binpb")
    assert got.open_hashed_file(name, compressed=True).read() == \
        want.open_hashed_file(name, compressed=True).read()
    for fs, err in ((got, errors), (want, jerrors)):
        with pytest.raises(err.IOError_) as e:
            fs.open_hashed_file("attributes/none.binpb")
        msg = str(e.value)
        with pytest.raises(err.IOError_):
            fs.read_named("labels/none")
    assert msg == "no such object: attributes/none.binpb"


def test_named_files_refused_by_default():
    class Plain(io.FileSystem):
        def create_hashed_file(self, subdir="", compress=False):
            raise AssertionError

        def open_hashed_file(self, path, compressed=False):
            raise errors.IOError_(path)

    with pytest.raises(errors.InvalidContext, match="does not support"):
        Plain().write_named("labels/x", b"")
    with pytest.raises(errors.InvalidContext, match="does not support"):
        Plain().read_named("labels/x")
    assert not Plain().exists("x")


def test_native_bindings_match_jax():
    """Each binding of the port's runtime gives the JAX runtime's result
    on the same inputs."""
    rng = np.random.default_rng(9)
    assert _native.available() and j_native.available()
    table = rng.standard_normal((4, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (300, 4)).astype(np.uint32)
    np.testing.assert_array_equal(_native.adc_sum(table, codes),
                                  j_native.adc_sum(table, codes))
    for k in (1, 10, 300, 400):
        for a, b in zip(_native.adc_topk(table, 0.5, codes, k),
                        j_native.adc_topk(table, 0.5, codes, k)):
            np.testing.assert_array_equal(a, b)
    tables = rng.standard_normal((3, 4, 16)).astype(np.float32)
    parts = [codes[:0].copy(), codes[:7].copy(), codes[7:].copy()]
    qn = rng.standard_normal(3).astype(np.float32)
    idx, dist, cnt = _native.adc_topk_batch(tables, qn, parts, 10)
    j_idx, j_dist, j_cnt = j_native.adc_topk_batch(tables, qn, parts, 10)
    np.testing.assert_array_equal(cnt, j_cnt)
    for j, c in enumerate(cnt):             # past cnt the rows are unset
        np.testing.assert_array_equal(idx[j, :c], j_idx[j, :c])
        np.testing.assert_array_equal(dist[j, :c], j_dist[j, :c])
    d = rng.standard_normal(1000).astype(np.float32)
    d[::7] = d[3]                       # ties: the stable order must hold
    np.testing.assert_array_equal(_native.topk_f32(d, 50),
                                  j_native.topk_f32(d, 50))
    from flechasdb_tpu.protos import wire as jwire
    payload = jwire.encode_packed_u32(
        rng.integers(0, 2**32, 500, dtype=np.uint64))
    np.testing.assert_array_equal(_native.varint_u32(payload),
                                  j_native.varint_u32(payload))
    assert _native.varint_u32(payload[:-1] + b"\x80") is None
    data = _payload(10_000, 4)
    assert _native.pack(data, True) == j_native.pack(data, True)
    assert _native.unpack(_native.pack(data, True)[0], True) == \
        j_native.unpack(j_native.pack(data, True)[0], True)
    assert _native.hash_name(data) == j_native.hash_name(data)


@pytest.mark.parametrize("k", [1, 10, 999, 1000, 2000])
def test_topk_stable_routes_agree(k, monkeypatch):
    d = np.random.default_rng(k).standard_normal(1000).astype(np.float32)
    d[::5] = d[1]
    want = np.argsort(d, kind="stable")[:k]
    np.testing.assert_array_equal(stored.topk_stable(d, k), want)
    monkeypatch.setattr(_native, "_load", lambda: None)
    np.testing.assert_array_equal(stored.topk_stable(d, k), want)


def test_runtime_builds_into_the_ports_build_dir(tmp_path, monkeypatch):
    """The library builds beside the port (never into the JAX package's
    ``_lib``), through a per-process temp name renamed into place, and
    is rebuilt when its source is newer."""
    assert _native._LIB_PATH.parent.name == "build"
    assert _native._LIB_PATH.parent.parent.name == "flechasdb_tpu_torch"
    src = tmp_path / "fastio.cc"
    src.write_bytes(_native._SRC_PATH.read_bytes())
    lib = tmp_path / "build" / "libflechas_io.so"
    monkeypatch.setattr(_native, "_SRC_PATH", src)
    monkeypatch.setattr(_native, "_LIB_PATH", lib)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    assert _native.available() and lib.exists()
    assert os.listdir(lib.parent) == [lib.name]
    first = lib.stat().st_mtime_ns
    os.utime(src, ns=(first + 10**9, first + 10**9))
    monkeypatch.setattr(_native, "_tried", False)
    assert _native.available()
    assert lib.stat().st_mtime_ns > first
    assert _native.hash_name(b"x") == jio.content_hash(b"x")
