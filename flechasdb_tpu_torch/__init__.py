"""flechasdb-tpu on PyTorch and CUDA.

The port of the JAX package's build → query paths to PyTorch (the
bucketed and masked layouts, exact rerank), with hand-written CUDA kernels
for an NVIDIA H100 (``sm_90a``):

* K-A, the ADC bucket scan of every query (``csrc/adc_scan.cu``), also
  behind ``ops.scan.adc_lookup``;
* K-B, the fused Lloyd round of the coarse fit and of PQ fits whose
  subvector width does not divide 128 (``csrc/lloyd_round.cu``);
* K-C, the fused Lloyd round over division-grouped data, for PQ widths
  m < 128 that divide 128 (``csrc/lloyd_grouped.cu``).

Work runs on an explicit device, ``"cuda"`` by default. On a CPU tensor
each kernel's plain PyTorch version runs instead; on a CUDA tensor the
kernel launches or the call raises. The port imports neither jax nor the
JAX package (whose ``__init__`` imports jax): it carries copies of the
few jax-free host helpers it needs (:mod:`.errors`, :mod:`.events`,
:mod:`.host`), with the same names and messages.
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

from .build import Database, DatabaseBuilder, QueryResult
from .convert import from_jax_arrays, to_arrays

__all__ = [
    "Database",
    "DatabaseBuilder",
    "FlechasError",
    "InvalidArgs",
    "InvalidContext",
    "InvalidData",
    "IOError_",
    "ProtobufError",
    "QueryResult",
    "VerificationFailure",
    "from_jax_arrays",
    "to_arrays",
]
