"""Asyncio read path.

Reference (``src/asyncdb/``): a read-only async mirror of the stored-database
layer, built so serverless readers can overlap partition fetches — the tokio
``Query`` future loads codebooks and all ``nprobe`` partitions concurrently
and executes each partition's ADC scan as soon as its inputs are ready
(``asyncdb/stored/query.rs:208-356``).

Here the hand-written poll state machines become plain ``asyncio``
coroutines: once-only concurrent loads are memoized ``asyncio.Task``s (the
``tokio::sync::OnceCell`` analogue), fan-out is ``asyncio.gather``, and
file/zlib work runs in worker threads via ``asyncio.to_thread`` (the
``AsyncZlibDecoder`` analogue — CPython releases the GIL inside zlib).
Device compute stays synchronous per step, as in the sync path.

The port's copy of the JAX package's ``asyncdb`` (for the reason given in
:mod:`..errors`), with the same names, results and events.
"""

from .io import AsyncFileSystem, AsyncLocalFileSystem
from .save import save_database
from .stored import AsyncStoredDatabase, AsyncQueryResult, load_database

__all__ = [
    "AsyncFileSystem",
    "AsyncLocalFileSystem",
    "AsyncQueryResult",
    "AsyncStoredDatabase",
    "load_database",
    "save_database",
]
