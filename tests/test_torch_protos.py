"""The port's protobuf codec (``flechasdb_tpu_torch/protos``) against the
JAX package's, message class by message class.

For each class the same fields, made from a numpy seed, are encoded by
both packages: the bytes must be equal, decoding must give the message
back, and truncated or garbled payloads must fail with the same
``ProtobufError`` message (or decode to the same message) in both.
"""

import numpy as np
import pytest

from flechasdb_tpu import protos as jprotos
from flechasdb_tpu.protos import wire as jwire
from flechasdb_tpu_torch import protos
from flechasdb_tpu_torch.protos import wire

CLASSES = ["PUuid", "PVectorSet", "PEncodedVectorSet", "PPartition",
           "PAttributeValue", "POperationSetAttribute", "PAttributesLog",
           "PDatabase", "PFlatChunk", "PFlatDatabase"]


def _make(mod, name: str, seed: int):
    """One message of class ``name`` from ``mod``'s codec."""
    rng = np.random.default_rng(seed)

    def uuid():
        return mod.PUuid(upper=int(rng.integers(1, 2**63)),
                         lower=int(rng.integers(1, 2**63)))

    def floats(n):
        return rng.standard_normal(n).astype(np.float32)

    def value():
        return mod.PAttributeValue(
            value=f"v{int(rng.integers(1000))}" if rng.random() < 0.5
            else int(rng.integers(0, 2**62)))

    def op():
        return mod.POperationSetAttribute(vector_id=uuid(),
                                          name_index=int(rng.integers(5)),
                                          value=value())

    def ids(n):
        return [f"id{int(rng.integers(10**6))}" for _ in range(n)]

    if name == "PUuid":
        return uuid()
    if name == "PVectorSet":
        return mod.PVectorSet(vector_size=4, data=floats(24))
    if name == "PEncodedVectorSet":
        data = rng.integers(0, 2**32, 30, dtype=np.uint64).astype(np.uint32)
        data[:10] = rng.integers(0, 256, 10)
        return mod.PEncodedVectorSet(vector_size=3, data=data)
    if name == "PPartition":
        return mod.PPartition(
            vector_size=8, num_divisions=4, centroid=floats(8),
            encoded_vectors=mod.PEncodedVectorSet(
                vector_size=4, data=rng.integers(0, 256, 20).astype(
                    np.uint32)),
            vector_ids=[uuid() for _ in range(5)])
    if name == "PAttributeValue":
        return value()
    if name == "POperationSetAttribute":
        return op()
    if name == "PAttributesLog":
        return mod.PAttributesLog(partition_id=ids(1)[0],
                                  entries=[op() for _ in range(4)])
    if name == "PDatabase":
        return mod.PDatabase(
            vector_size=16, num_partitions=3, num_divisions=4,
            num_codes=256, partition_ids=ids(3),
            partition_centroids_id=ids(1)[0], codebook_ids=ids(4),
            attributes_log_ids=ids(3), attribute_names=["lang", "tenant"],
            rotation_id=ids(1)[0], metric="dot")
    if name == "PFlatChunk":
        return mod.PFlatChunk(
            vector_size=4, vectors=mod.PVectorSet(vector_size=4,
                                                  data=floats(12)),
            vector_ids=[uuid() for _ in range(3)])
    return mod.PFlatDatabase(vector_size=4, num_vectors=10,
                             chunk_ids=ids(2), attributes_log_ids=ids(2),
                             attribute_names=["a"], metric="cosine")


def _decode(mod, name: str, buf: bytes):
    """``("ok", re-encoded bytes)`` or ``(error class name, message)``."""
    try:
        return "ok", getattr(mod, name).decode(buf).encode()
    except Exception as e:          # the two codecs must fail alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CLASSES)
def test_message_matches_jax(name, seed):
    got, want = _make(protos, name, seed), _make(jprotos, name, seed)
    buf = got.encode()
    assert buf == want.encode()
    assert getattr(protos, name).decode(buf).encode() == buf
    assert _decode(protos, name, buf) == _decode(jprotos, name, buf)
    rng = np.random.default_rng(100 + seed)
    broken = [buf[:n] for n in range(len(buf))]
    for _ in range(40):
        b = bytearray(buf)
        for i in rng.integers(0, len(b), int(rng.integers(1, 4))):
            b[i] = int(rng.integers(256))
        broken.append(bytes(b))
    broken.append(buf + bytes([0x52, 0xFF, 0xFF]))
    failed = 0
    for b in broken:
        mine, ref = _decode(protos, name, b), _decode(jprotos, name, b)
        assert mine == ref, (b, mine, ref)
        failed += mine[0] != "ok"
    assert failed > 0 or name == "PUuid"


def test_every_message_class_is_copied():
    assert sorted(protos.__all__) == sorted(jprotos.__all__) == \
        sorted(CLASSES)


@pytest.mark.parametrize("values", [[0, 1, 127, 128, 2**14, 2**28,
                                     2**32 - 1], list(range(300))])
def test_packed_varints_match_jax(values):
    arr = np.array(values, np.uint32)
    payload = wire.encode_packed_u32(arr)
    assert payload == jwire.encode_packed_u32(arr)
    np.testing.assert_array_equal(wire.decode_packed_u32(payload), arr)
    for bad in (payload[:-1] + b"\x80", b"\xff" * 11):
        msgs = []
        for w in (wire, jwire):
            with pytest.raises(Exception) as e:
                w.decode_packed_u32(bad)
            msgs.append((type(e.value).__name__, str(e.value)))
        assert msgs[0] == msgs[1]
