"""Protocol Buffers wire codec for the database format.

Wire-compatible with the reference schema (``src/protos/database.proto``)
without depending on generated code: the messages are small and fixed, and a
hand-rolled codec lets the hot fields — multi-megabyte packed float arrays
and packed-varint PQ codes — decode straight into numpy buffers
(``np.frombuffer`` for floats, a vectorized varint kernel for codes) instead
of crawling through a generic protobuf runtime object tree. That keeps the
host-side load path fast enough to feed the device.

A copy of the JAX package's ``protos`` (for the reason given in
:mod:`..errors`); ``tests/test_torch_protos.py`` holds it against the
original.
"""

from .messages import (
    PAttributesLog,
    PFlatChunk,
    PFlatDatabase,
    PAttributeValue,
    PDatabase,
    PEncodedVectorSet,
    POperationSetAttribute,
    PPartition,
    PUuid,
    PVectorSet,
)

__all__ = [
    "PAttributesLog",
    "PFlatChunk",
    "PFlatDatabase",
    "PAttributeValue",
    "PDatabase",
    "PEncodedVectorSet",
    "POperationSetAttribute",
    "PPartition",
    "PUuid",
    "PVectorSet",
]
