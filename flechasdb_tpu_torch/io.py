"""Content-addressed storage.

Reference model (``src/io.rs``): every artifact is written through a hashing
stream and persisted under ``URL-safe-base64(SHA-256(file bytes))`` — for
compressed artifacts the hash covers the *compressed* bytes, because the
hasher sits below the zlib encoder (``io.rs:126-128``). Writes are crash-safe
via tempfile + atomic rename (``io.rs:242-256``); readers hash as they read
and ``verify()`` against the filename stem (``io.rs:286-300``). Corruption
surfaces as :class:`VerificationFailure`.

``FileSystem`` is the extension seam (the reference's out-of-tree
``flechasdb-s3`` proves it): implement four methods to put databases on any
object store.

A copy of the JAX package's ``io.py`` (for the reason given in
:mod:`.errors`); ``tests/test_torch_io.py`` holds it against the original.
"""

from __future__ import annotations

import base64
import hashlib
import os
import tempfile
import zlib
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

from . import _native
from .errors import IOError_, VerificationFailure

#: zlib level matching flate2's ``Compression::default()`` (``io.rs:104``).
COMPRESSION_LEVEL = 6


def content_hash(data: bytes) -> str:
    """URL-safe base64 (no padding) of SHA-256 — file naming scheme
    (``io.rs:248-249``). Uses the native runtime when present."""
    native = _native.hash_name(data)
    if native is not None:
        return native
    digest = hashlib.sha256(data).digest()
    return base64.urlsafe_b64encode(digest).decode("ascii").rstrip("=")


class HashedFileWriter:
    """Write buffer persisted under the hash of its (stored) bytes.

    With ``compress=True`` the payload is zlib-compressed and the hash covers
    the compressed stream, matching the reference's layering
    (``io.rs:122-129``).
    """

    def __init__(self, persist_cb, compress: bool) -> None:
        self._persist_cb = persist_cb
        self._compress = compress
        self._chunks: list[bytes] = []
        self._persisted = False

    def write(self, data: bytes) -> int:
        self._chunks.append(bytes(data))
        return len(data)

    def persist(self, extension: str = "binpb") -> str:
        """Finalizes and stores the file; returns its content hash.

        Deflate + SHA-256 run in one native pass when the runtime is
        loaded (``native/fastio.cc``), mirroring the reference's
        hash-under-encoder stream stack (``io.rs:122-129``).
        """
        if self._persisted:
            raise IOError_("file already persisted")
        payload = b"".join(self._chunks)
        packed = _native.pack(payload, self._compress, COMPRESSION_LEVEL)
        if packed is not None:
            payload, hash_ = packed
        else:
            if self._compress:
                payload = zlib.compress(payload, COMPRESSION_LEVEL)
            hash_ = content_hash(payload)
        self._persist_cb(payload, f"{hash_}.{extension}")
        self._persisted = True
        return hash_


class HashedFileReader:
    """Read buffer that can verify its content hash against its name."""

    def __init__(self, raw: bytes, name: str, compressed: bool) -> None:
        self._raw = raw
        self._name = name
        self._compressed = compressed
        self._hash: Optional[str] = None

    def read(self, need_hash: bool = True) -> bytes:
        """Returns the (decompressed) payload.

        With the native runtime, inflate and the verification hash happen
        in one pass (hash-as-you-read, ``io.rs:258-300``).
        ``need_hash=False`` skips the hash pass — callers that will not
        :meth:`verify` (the sync path's centroid/attr-log quirk) shouldn't
        pay it; a later ``verify()`` still works (it re-hashes the raw
        bytes, which this reader keeps).
        """
        try:
            unpacked = _native.unpack(self._raw, self._compressed,
                                      need_hash)
        except ValueError as e:
            raise IOError_(f"zlib decompression failed: {e}") from e
        if unpacked is not None:
            payload, self._hash = unpacked
            return payload
        if self._compressed:
            try:
                return zlib.decompress(self._raw)
            except zlib.error as e:
                raise IOError_(f"zlib decompression failed: {e}") from e
        return self._raw

    def verify(self) -> None:
        """Checks SHA-256 of the stored bytes against the filename stem
        (``io.rs:286-300``)."""
        hash_ = self._hash or content_hash(self._raw)
        stem = self._name.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        if hash_ != stem:
            raise VerificationFailure(
                f"Expected hash {stem!r}, but got {hash_}")


class FileSystem(ABC):
    """Storage abstraction (``io.rs:18-64``)."""

    @abstractmethod
    def create_hashed_file(self, subdir: str = "",
                           compress: bool = False) -> HashedFileWriter:
        """Creates a writer whose final name is the hash of its contents."""

    @abstractmethod
    def open_hashed_file(self, path: str,
                         compressed: bool = False) -> HashedFileReader:
        """Opens a stored file for reading/verification."""

    # -- named (mutable) files — the label seam (EXTENSION, catalog.py) ----
    #
    # Content addressing answers "are these the bytes?" but not "which
    # root is current?"; labels are small mutable pointer files under
    # ``labels/``. Backends that can write a named file atomically
    # override these; the defaults reject (e.g. a read-only mirror).

    def write_named(self, path: str, data: bytes) -> None:
        """Atomically writes a small mutable named file (labels)."""
        from .errors import InvalidContext
        raise InvalidContext(
            f"{type(self).__name__} does not support named (label) files")

    def read_named(self, path: str) -> bytes:
        """Reads a named file written by :meth:`write_named`."""
        from .errors import InvalidContext
        raise InvalidContext(
            f"{type(self).__name__} does not support named (label) files")

    def exists(self, path: str) -> bool:
        """Cheap existence probe. The default downloads the object (all
        the ABC guarantees is ``open_hashed_file``); backends override
        with a metadata stat where they can."""
        try:
            self.open_hashed_file(path)
            return True
        except IOError_:
            return False


class LocalFileSystem(FileSystem):
    """Local directory store: tempfile + atomic rename (``io.rs:210-256``)."""

    def __init__(self, base_path) -> None:
        self.base_path = Path(base_path)
        # str base + os.path on the read path: pathlib's parse/join cost
        # ~0.1 ms per root-manifest load and per cold partition read.
        self._base_str = str(self.base_path)

    def create_hashed_file(self, subdir: str = "",
                           compress: bool = False) -> HashedFileWriter:
        target_dir = self.base_path / subdir if subdir else self.base_path

        def persist_cb(payload: bytes, filename: str) -> None:
            try:
                target_dir.mkdir(parents=True, exist_ok=True)
                target = target_dir / filename
                try:
                    if target.stat().st_size == len(payload):
                        # Content-addressed: an existing name IS these
                        # bytes (writes are atomic). Skipping makes
                        # re-saves of updated databases O(touched
                        # artifacts) in bytes written. The size check
                        # keeps the store self-healing: a short file
                        # under a valid name (interrupted copy from
                        # elsewhere, truncation) is overwritten, not
                        # trusted.
                        return
                except OSError:
                    pass        # missing: write it
                fd, tmp = tempfile.mkstemp(dir=target_dir)
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(payload)
                    os.replace(tmp, target_dir / filename)
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
            except OSError as e:
                raise IOError_(str(e)) from e

        return HashedFileWriter(persist_cb, compress)

    def open_hashed_file(self, path: str,
                         compressed: bool = False) -> HashedFileReader:
        try:
            with open(os.path.join(self._base_str, path), "rb") as f:
                raw = f.read()
        except OSError as e:
            raise IOError_(str(e)) from e
        return HashedFileReader(raw, path.rsplit("/", 1)[-1], compressed)

    def write_named(self, path: str, data: bytes) -> None:
        """Tempfile + atomic rename, like the content store's writes."""
        target = self.base_path / path
        try:
            target.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=target.parent)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, target)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        except OSError as e:
            raise IOError_(str(e)) from e

    def read_named(self, path: str) -> bytes:
        try:
            with open(os.path.join(self._base_str, path), "rb") as f:
                return f.read()
        except OSError as e:
            raise IOError_(str(e)) from e

    def exists(self, path: str) -> bool:
        return os.path.exists(os.path.join(self._base_str, path))
