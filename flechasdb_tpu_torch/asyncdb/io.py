"""Async content-addressed storage (read-only).

Reference (``src/asyncdb/io.rs``): an async mirror of the sync ``FileSystem``
restricted to reads — hash-as-you-read verification plus a hand-driven async
zlib decoder over a 1 KiB ring (``asyncdb/io.rs:200-363``). There is no async
write path (``README.md:50-52``), and we keep that scope.

The asyncio translation: blocking file reads and zlib inflation run in
worker threads (``asyncio.to_thread``); CPython's zlib releases the GIL, so
decompression genuinely overlaps with other partition fetches — the same
I/O-interleaving the tokio reactor provides.

A copy of the JAX package's ``asyncdb/io.py`` over the port's
:mod:`.._native`, :mod:`..io` and :mod:`..errors` (for the reason given in
:mod:`..errors`); ``tests/test_torch_asyncdb.py`` holds it against the
original.
"""

from __future__ import annotations

import asyncio
import zlib
from abc import ABC, abstractmethod
from pathlib import Path

from .. import _native
from ..errors import IOError_, VerificationFailure
from ..io import content_hash


class AsyncHashedFileReader:
    """Async counterpart of :class:`..io.HashedFileReader`
    (``asyncdb/io.rs:42-55``)."""

    def __init__(self, raw: bytes, name: str, compressed: bool) -> None:
        self._raw = raw
        self._name = name
        self._compressed = compressed
        self._hash = None

    #: Payloads at or under this run inline on the event loop: the
    #: executor round trip of ``asyncio.to_thread`` costs ~0.1–0.3 ms on
    #: a 1-core host — more than inflating a small artifact (the root
    #: manifest is a few KB) takes outright. Larger artifacts (partition
    #: files) keep the off-loop pass so concurrent loads overlap.
    _INLINE_BYTES = 16 << 10

    async def read(self) -> bytes:
        """Returns the (decompressed) payload; inflation runs off-loop
        for large payloads (small ones inline — see ``_INLINE_BYTES``).

        With the native runtime, inflate + verification hash happen in one
        C++ pass with the GIL released — concurrent partition reads
        genuinely overlap.
        """
        def work() -> tuple[bytes, str | None]:
            unpacked = _native.unpack(self._raw, self._compressed)
            if unpacked is not None:
                return unpacked
            if self._compressed:
                return zlib.decompress(self._raw), None
            return self._raw, None

        try:
            if len(self._raw) <= self._INLINE_BYTES:
                payload, hash_ = work()
            else:
                payload, hash_ = await asyncio.to_thread(work)
        except (zlib.error, ValueError) as e:
            raise IOError_(f"zlib decompression failed: {e}") from e
        if hash_ is not None:
            self._hash = hash_
        return payload

    def verify(self) -> None:
        """SHA-256 of stored bytes vs filename stem (``asyncdb/io.rs:161-176``).

        The async path verifies *every* artifact (unlike the sync path's
        centroids/attributes quirk, SURVEY.md §5).
        """
        hash_ = self._hash or content_hash(self._raw)
        stem = Path(self._name).stem
        if hash_ != stem:
            raise VerificationFailure(
                f"Expected hash {stem!r}, but got {hash_}")


class AsyncStreamingHashedFileReader:
    """Incremental reader: hash + inflate chunk-by-chunk off-loop.

    The reference inflates inside ``poll_read`` over a 1 KiB input ring
    (``asyncdb/io.rs:200-363``) so the compressed stream is never resident
    in full. Same property here: the file streams through a bounded chunk
    buffer with SHA-256 and ``zlib.decompressobj`` advancing incrementally;
    only the decompressed payload accumulates. Drop-in for
    :class:`AsyncHashedFileReader` (``read`` then ``verify``); ``verify``
    before ``read`` is an error since no bytes have been hashed yet.
    """

    def __init__(self, path, name: str, compressed: bool,
                 chunk_size: int = 1 << 16) -> None:
        self._path = path
        self._name = name
        self._compressed = compressed
        self._chunk_size = chunk_size
        self._hash = None

    async def read(self) -> bytes:
        import hashlib

        def work() -> bytes:
            import base64

            h = hashlib.sha256()
            d = zlib.decompressobj() if self._compressed else None
            out = []
            with open(self._path, "rb") as f:
                while chunk := f.read(self._chunk_size):
                    h.update(chunk)
                    out.append(d.decompress(chunk) if d else chunk)
                if d is not None:
                    out.append(d.flush())
            self._hash = base64.urlsafe_b64encode(
                h.digest()).decode("ascii").rstrip("=")
            return b"".join(out)

        try:
            return await asyncio.to_thread(work)
        except zlib.error as e:
            raise IOError_(f"zlib decompression failed: {e}") from e
        except OSError as e:
            raise IOError_(str(e)) from e

    def verify(self) -> None:
        if self._hash is None:
            raise IOError_("verify() before read() on a streaming reader")
        stem = Path(self._name).stem
        if self._hash != stem:
            raise VerificationFailure(
                f"Expected hash {stem!r}, but got {self._hash}")


class AsyncFileSystem(ABC):
    """Read-only async storage abstraction (``asyncdb/io.rs:20-39``)."""

    @abstractmethod
    async def open_hashed_file(self, path: str,
                               compressed: bool = False,
                               ) -> AsyncHashedFileReader:
        """Opens a stored file for reading/verification."""


class AsyncLocalFileSystem(AsyncFileSystem):
    """Local directory store (``asyncdb/io.rs:104-198``).

    Files at or above ``streaming_threshold`` bytes use the incremental
    reader (bounded compressed-side memory, reference ring-decoder
    parity); smaller files are read whole and inflated in one native
    GIL-released pass, which is faster at artifact sizes.
    """

    def __init__(self, base_path,
                 streaming_threshold: int = 8 << 20) -> None:
        self.base_path = Path(base_path)
        self.streaming_threshold = streaming_threshold

    async def open_hashed_file(self, path: str,
                               compressed: bool = False,
                               ) -> AsyncHashedFileReader:
        full = self.base_path / path
        try:
            # stat is a metadata syscall (µs even cold) — inline; each
            # asyncio.to_thread executor round trip costs ~0.1–0.3 ms on
            # a 1-core host, which dominated small-artifact opens (the
            # root manifest load). Small files read inline too; larger
            # ones keep the off-loop read so concurrent loads overlap.
            size = full.stat().st_size
            if size >= self.streaming_threshold:
                return AsyncStreamingHashedFileReader(
                    full, full.name, compressed)
            if size <= AsyncHashedFileReader._INLINE_BYTES:
                raw = full.read_bytes()
            else:
                raw = await asyncio.to_thread(full.read_bytes)
        except OSError as e:
            raise IOError_(str(e)) from e
        return AsyncHashedFileReader(raw, full.name, compressed)
