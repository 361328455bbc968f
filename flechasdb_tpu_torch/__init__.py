"""flechasdb-tpu on PyTorch and CUDA.

The port of the JAX package's build → query paths to PyTorch (the
bucketed and masked layouts, exact rerank, attribute filters, range search
and updates of the in-memory database, fast-math training and OPQ), of
its stored tiers
(``save_database`` writes the JAX package's content-addressed tree, byte
for byte; ``load_database`` reads it lazily, queries cold on the host and,
after ``StoredDatabase.preload``, serves from the device; :mod:`.asyncdb`
loads, queries and saves the same trees from asyncio; the fsspec object
store, whose ``fsspec`` is imported at first use, never with the package),
of the flat (exact-search) tier (:mod:`.flat`, the exact scan on the
device), of the Deep10M-scale builds (:mod:`.parallel`, ``build_staged``
with training caps) and the streaming build
(:class:`StreamingDatabaseBuilder`, corpora larger than the device), of
the multi-GPU scale-out on ``torch.distributed`` (:mod:`.parallel`: the
sharded build, sharded serving, ``preload(mesh=)`` and ``with_mesh``),
and of the CLI (``python -m flechasdb_tpu_torch``), with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``):

* K-A, the ADC bucket scan of every query (``csrc/adc_scan.cu``), also
  behind ``ops.scan.adc_lookup``;
* K-B, the fused Lloyd round of the coarse fit and of PQ fits whose
  subvector width does not divide 128 (``csrc/lloyd_round.cu``);
* K-C, the fused Lloyd round over division-grouped data, for PQ widths
  m < 128 that divide 128 (``csrc/lloyd_grouped.cu``);
* the ``fast_math`` variants of K-B and K-C (one bf16 tensor-core pass),
  for ``DatabaseBuilder.with_fast_math``.

Work runs on an explicit device, ``"cuda"`` by default. On a CPU tensor
each kernel's plain PyTorch version runs instead; on a CUDA tensor the
kernel launches or the call raises. The port imports neither jax nor the
JAX package (whose ``__init__`` imports jax): it carries copies of the
jax-free host code it needs (:mod:`.errors`, :mod:`.events`,
:mod:`.host`, :mod:`.attributes`, :mod:`.filters`, and the storage layer:
:mod:`.io`, :mod:`.protos`, :mod:`._native` with ``native/fastio.cc``,
:mod:`.serialize`, :mod:`.stored`, :mod:`.memfs`, :mod:`.catalog`,
:mod:`.asyncdb`, :mod:`.objectstore`, :mod:`.utils`), with the same names
and messages.
"""

from .errors import (
    FlechasError,
    InvalidArgs,
    InvalidContext,
    InvalidData,
    IOError_,
    ProtobufError,
    VerificationFailure,
)

from .attributes import AttributeTable, Attributes, AttributeValue
from .build import Database, DatabaseBuilder, QueryResult
from .catalog import load_labeled, publish_label, resolve_label
from .convert import from_jax_arrays, to_arrays
from .filters import Eq, Exists, Filter, In, Range
from .flat import (
    FlatDatabase,
    StoredFlatDatabase,
    load_flat_database,
    load_flat_database_async,
    save_flat_database,
)
from .host import VALID_METRICS
from .io import FileSystem, LocalFileSystem
from .memfs import MemoryFileSystem
from .objectstore import AsyncFsspecFileSystem, FsspecFileSystem
from .serialize import save_database
from .stored import StoredDatabase, StoredQueryResult, load_database
from .streaming import StreamingDatabaseBuilder

__all__ = [
    "AsyncFsspecFileSystem",
    "AttributeTable",
    "Attributes",
    "AttributeValue",
    "Database",
    "DatabaseBuilder",
    "Eq",
    "Exists",
    "FileSystem",
    "Filter",
    "FlatDatabase",
    "FlechasError",
    "FsspecFileSystem",
    "InvalidArgs",
    "InvalidContext",
    "InvalidData",
    "IOError_",
    "In",
    "LocalFileSystem",
    "MemoryFileSystem",
    "ProtobufError",
    "QueryResult",
    "Range",
    "StoredDatabase",
    "StoredFlatDatabase",
    "StoredQueryResult",
    "StreamingDatabaseBuilder",
    "VALID_METRICS",
    "VerificationFailure",
    "from_jax_arrays",
    "load_database",
    "load_flat_database",
    "load_flat_database_async",
    "load_labeled",
    "publish_label",
    "resolve_label",
    "save_database",
    "save_flat_database",
    "to_arrays",
]
