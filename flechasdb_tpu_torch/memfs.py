"""In-memory object store — the ``FileSystem`` extension seam, exercised.

The reference proves its storage abstraction with an out-of-tree S3
implementation (``flechasdb-s3``, README.md:76). This module is the same
proof in-tree: a complete alternative backend over one dict. Useful as-is
for ephemeral databases and tests; a real object-store backend (GCS/S3)
only has to swap the dict for client calls, exactly like the reference's
S3 crate swaps local files.

A copy of the JAX package's ``memfs.py`` (for the reason given in
:mod:`.errors`): ``MemoryFileSystem`` and its asyncio view
``AsyncMemoryFileSystem``.
"""

from __future__ import annotations

from typing import Dict

from .asyncdb.io import AsyncFileSystem, AsyncHashedFileReader
from .errors import IOError_
from .io import FileSystem, HashedFileReader, HashedFileWriter


class MemoryFileSystem(FileSystem):
    """Sync content-addressed store over a dict (path → stored bytes)."""

    def __init__(self, objects: Dict[str, bytes] | None = None) -> None:
        self.objects: Dict[str, bytes] = objects if objects is not None \
            else {}

    def create_hashed_file(self, subdir: str = "",
                           compress: bool = False) -> HashedFileWriter:
        def persist_cb(payload: bytes, filename: str) -> None:
            key = f"{subdir}/{filename}" if subdir else filename
            self.objects[key] = payload

        return HashedFileWriter(persist_cb, compress)

    def open_hashed_file(self, path: str,
                         compressed: bool = False) -> HashedFileReader:
        try:
            raw = self.objects[path]
        except KeyError:
            raise IOError_(f"no such object: {path}") from None
        return HashedFileReader(raw, path.rsplit("/", 1)[-1], compressed)

    def write_named(self, path: str, data: bytes) -> None:
        self.objects[path] = data

    def read_named(self, path: str) -> bytes:
        try:
            return self.objects[path]
        except KeyError:
            raise IOError_(f"no such object: {path}") from None

    def exists(self, path: str) -> bool:
        return path in self.objects


class AsyncMemoryFileSystem(AsyncFileSystem):
    """Asyncio view over the same dict (read-only, like the reference's
    async path)."""

    def __init__(self, objects: Dict[str, bytes]) -> None:
        self.objects = objects

    async def open_hashed_file(self, path: str,
                               compressed: bool = False,
                               ) -> AsyncHashedFileReader:
        try:
            raw = self.objects[path]
        except KeyError:
            raise IOError_(f"no such object: {path}") from None
        return AsyncHashedFileReader(raw, path.rsplit("/", 1)[-1],
                                     compressed)
