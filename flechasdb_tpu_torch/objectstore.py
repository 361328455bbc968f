"""Object-store backends via fsspec — the real-world ``FileSystem`` seam.

The reference's extension proof is an out-of-tree S3 crate
(``flechasdb-s3``, ``README.md:76``) implementing its ``FileSystem`` /
async ``FileSystem`` traits against a real object store. This module is the
equivalent here: one backend that speaks every protocol fsspec knows
(``s3://``, ``gs://``, ``az://``, ``memory://``, ``file://``, ...), sync
and async. The tests exercise it over ``file://`` and ``memory://`` — the
protocol-specific client is fsspec's job, exactly as the S3 SDK is the
reference crate's.

Durability note: object stores PUT whole objects atomically, so the
tempfile+rename dance of :class:`.io.LocalFileSystem` is unnecessary
there; for the ``file``/``local`` protocol we keep write-then-move so a
crash never leaves a half-written artifact under its final name
(``io.rs:242-256`` semantics).

A copy of the JAX package's ``objectstore.py`` over the port's storage
layer (for the reason given in :mod:`.errors`), with one repair: the
temporary name of a local write is unique per writer (the PID and a random
token, :func:`_tmp_name`), where the JAX package's is the PID alone, which
two threads of one process saving the same object share. The bytes and the
final names do not change. ``fsspec`` is imported at first use, never with
the package.
"""

from __future__ import annotations

import asyncio
import os
import secrets

from .errors import IOError_
from .io import FileSystem, HashedFileReader, HashedFileWriter
from .asyncdb.io import AsyncFileSystem, AsyncHashedFileReader


def _fsspec():
    try:
        import fsspec
    except ImportError as e:
        raise IOError_(
            "fsspec is required for object-store backends "
            "(pip install fsspec[s3|gcs])") from e
    return fsspec


def _tmp_name(full: str) -> str:
    """A writer's own temporary name beside ``full``: concurrent writers of
    one object, in one process or several, never share it."""
    return f"{full}.tmp.{os.getpid()}.{secrets.token_hex(8)}"


def _split(url_or_fs, base_path: str):
    """Accepts an fsspec URL ("s3://bucket/prefix") or a live fsspec
    filesystem instance plus an explicit base path."""
    if isinstance(url_or_fs, str):
        fs, base = _fsspec().core.url_to_fs(url_or_fs)
        return fs, base
    return url_or_fs, base_path


def _is_local(fs) -> bool:
    """True for fsspec's local filesystem (where rename is atomic).

    ``fs.protocol`` may be a string OR a tuple (LocalFileSystem's is
    ``("file", "local")``) — a bare ``in ("file", "local")`` test never
    matches the tuple form.
    """
    proto = fs.protocol
    if isinstance(proto, (tuple, list)):
        return bool({"file", "local"} & set(proto))
    return proto in ("file", "local")


class FsspecFileSystem(FileSystem):
    """Sync content-addressed store on any fsspec filesystem."""

    def __init__(self, url_or_fs, base_path: str = "") -> None:
        self.fs, self.base_path = _split(url_or_fs, base_path)

    def _full(self, path: str) -> str:
        return f"{self.base_path}/{path}" if self.base_path else path

    def create_hashed_file(self, subdir: str = "",
                           compress: bool = False) -> HashedFileWriter:
        def persist_cb(payload: bytes, filename: str) -> None:
            rel = f"{subdir}/{filename}" if subdir else filename
            full = self._full(rel)
            try:
                try:
                    if self.fs.size(full) == len(payload):
                        # Content-addressed: the name pins the bytes, so
                        # an existing object needs no PUT (a size probe
                        # is cheaper than re-uploading the payload). The
                        # size check keeps the store self-healing: a
                        # truncated object under a valid name (failed
                        # multipart upload) is overwritten, not trusted.
                        return
                except (OSError, FileNotFoundError):
                    pass        # missing: write it
                parent = full.rsplit("/", 1)[0]
                if parent != full:
                    self.fs.makedirs(parent, exist_ok=True)
                if _is_local(self.fs):
                    tmp = _tmp_name(full)
                    self.fs.pipe_file(tmp, payload)
                    self.fs.mv(tmp, full)
                else:
                    self.fs.pipe_file(full, payload)  # atomic object PUT
            except OSError as e:
                raise IOError_(str(e)) from e

        return HashedFileWriter(persist_cb, compress)

    def open_hashed_file(self, path: str,
                         compressed: bool = False) -> HashedFileReader:
        full = self._full(path)
        try:
            raw = self.fs.cat_file(full)
        except (OSError, FileNotFoundError) as e:
            raise IOError_(str(e)) from e
        return HashedFileReader(raw, path.rsplit("/", 1)[-1], compressed)

    def write_named(self, path: str, data: bytes) -> None:
        """Label writes: atomic object PUT (rename-shuffle on local)."""
        full = self._full(path)
        try:
            parent = full.rsplit("/", 1)[0]
            if parent != full:
                self.fs.makedirs(parent, exist_ok=True)
            if _is_local(self.fs):
                tmp = _tmp_name(full)
                self.fs.pipe_file(tmp, data)
                self.fs.mv(tmp, full)
            else:
                self.fs.pipe_file(full, data)
        except OSError as e:
            raise IOError_(str(e)) from e

    def read_named(self, path: str) -> bytes:
        try:
            return self.fs.cat_file(self._full(path))
        except (OSError, FileNotFoundError) as e:
            raise IOError_(str(e)) from e

    def exists(self, path: str) -> bool:
        """Metadata probe (HEAD-equivalent), no object download."""
        try:
            return bool(self.fs.exists(self._full(path)))
        except OSError:
            return False


class AsyncFsspecFileSystem(AsyncFileSystem):
    """Asyncio view of the same store (read-only, like the reference's
    async path). Blocking client calls run off-loop, so nprobe partition
    fetches overlap — the serverless S3 use case the reference's async
    layer exists for (``asyncdb/stored/query.rs:248-254``)."""

    def __init__(self, url_or_fs, base_path: str = "") -> None:
        self.fs, self.base_path = _split(url_or_fs, base_path)

    def _full(self, path: str) -> str:
        return f"{self.base_path}/{path}" if self.base_path else path

    async def open_hashed_file(self, path: str,
                               compressed: bool = False,
                               ) -> AsyncHashedFileReader:
        full = self._full(path)
        try:
            raw = await asyncio.to_thread(self.fs.cat_file, full)
        except (OSError, FileNotFoundError) as e:
            raise IOError_(str(e)) from e
        return AsyncHashedFileReader(raw, path.rsplit("/", 1)[-1],
                                     compressed)
