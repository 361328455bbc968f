"""proto3 wire-format primitives.

Standard encoding rules (tags, varints, length-delimited fields, packed
repeated scalars) plus two numpy-vectorized bulk codecs:

* packed ``float``  ↔ ``np.float32`` arrays — raw little-endian reinterpret,
* packed ``uint32`` ↔ ``np.uint32`` arrays — branch-free vectorized varints.

These carry the entire data volume of a database file (``VectorSet.data``,
``EncodedVectorSet.data``, ``database.proto:66-85``), so they must not go
through per-element Python.
"""

from __future__ import annotations

import numpy as np

from .. import _native
from ..errors import ProtobufError

# wire types
WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5


def tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def encode_varint(v: int) -> bytes:
    if v < 0:
        raise ProtobufError(f"varint must be non-negative: {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Returns ``(value, next_pos)``."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ProtobufError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ProtobufError("varint too long")


def decode_utf8(payload: bytes, what: str = "string field") -> str:
    """UTF-8 decode with the protobuf error contract: malformed bytes in
    a ``string`` field are a wire-format violation (proto3 requires valid
    UTF-8; rust-protobuf rejects them the same way), so they surface as
    :class:`ProtobufError` — never a raw ``UnicodeDecodeError``."""
    try:
        return payload.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtobufError(f"invalid UTF-8 in {what}: {e}") from e


def concat_repeated(parts: list) -> np.ndarray:
    """Joins per-occurrence segments of a repeated scalar field.

    Proto3 merge semantics: multiple occurrences of a repeated field in
    one message (several packed segments, unpacked scalars, or a mix)
    CONCATENATE in arrival order — they never replace each other
    (rust-protobuf does the same, ``protos/mod.rs``)."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def encode_packed_floats(arr: np.ndarray) -> bytes:
    """Payload of a packed ``repeated float`` field."""
    return np.ascontiguousarray(arr, dtype="<f4").tobytes()


def decode_packed_floats(payload: bytes) -> np.ndarray:
    if len(payload) % 4:
        raise ProtobufError(
            f"packed float payload length {len(payload)} not a multiple of 4")
    return np.frombuffer(payload, dtype="<f4").copy()


def encode_packed_u32(arr: np.ndarray) -> bytes:
    """Payload of a packed ``repeated uint32`` field (vectorized varints)."""
    v = np.ascontiguousarray(arr).astype(np.uint64)
    if v.size == 0:
        return b""
    nb = (1 + (v >= 1 << 7).astype(np.int64) + (v >= 1 << 14)
          + (v >= 1 << 21) + (v >= 1 << 28))
    starts = np.empty_like(nb)
    starts[0] = 0
    np.cumsum(nb[:-1], out=starts[1:])
    out = np.zeros(int(starts[-1] + nb[-1]), np.uint8)
    for j in range(5):
        mask = nb > j
        if not mask.any():
            break
        byte = ((v[mask] >> np.uint64(7 * j)) & np.uint64(0x7F))
        cont = (nb[mask] - 1 > j)
        out[starts[mask] + j] = byte.astype(np.uint8) | (
            cont.astype(np.uint8) << 7)
    return out.tobytes()


def decode_packed_u32(payload: bytes) -> np.ndarray:
    """Decodes a packed ``repeated uint32`` payload (native scalar walk
    when the IO runtime is loaded — ~0.8 ms -> ~15 us per 12k-varint
    partition code block; vectorized numpy otherwise / on malformed
    input, for exact error reporting)."""
    if not payload:
        return np.zeros(0, np.uint32)
    got = _native.varint_u32(payload)
    if got is not None:
        return got
    b = np.frombuffer(payload, np.uint8)
    is_end = (b & 0x80) == 0
    if not is_end[-1]:
        raise ProtobufError("truncated varint in packed field")
    ends = np.nonzero(is_end)[0]
    starts = np.empty(len(ends), np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    gid = np.zeros(len(b), np.int64)
    gid[1:] = np.cumsum(is_end)[:-1]
    offset = np.arange(len(b), dtype=np.int64) - starts[gid]
    if (offset > 9).any():
        raise ProtobufError("varint too long in packed field")
    vals = (b & 0x7F).astype(np.uint64) << (7 * offset).astype(np.uint64)
    out = np.add.reduceat(vals, starts)
    if (out > 0xFFFFFFFF).any():
        raise ProtobufError("uint32 overflow in packed field")
    return out.astype(np.uint32)


def encode_uuid_records(field: int, raw: np.ndarray) -> bytes:
    """Bulk encoding of ``repeated Uuid`` messages (two fixed64 fields).

    ``raw: [N, 16] uint8`` big-endian UUID bytes (``uuid.UUID.bytes``).
    Requires every 64-bit half to be non-zero (proto3 skips zero scalars,
    which would change the record length) — callers check and fall back to
    the per-message path for the ~2⁻⁶⁴-probability zero halves. Each
    record is exactly 20 bytes: LEN tag, length 18, then the two fixed64
    fields in little-endian. Byte-identical to ``Writer.message_field``
    over ``PUuid`` (pinned by ``tests/test_protos.py``); exists because a
    100k-vector save spent ~0.5 s in the per-message Python loop.
    """
    if field >= 16:
        raise ProtobufError(f"single-byte tag required, got field {field}")
    n = raw.shape[0]
    out = np.empty((n, 20), np.uint8)
    out[:, 0] = (field << 3) | WT_LEN
    out[:, 1] = 18
    out[:, 2] = 0x09                     # tag(1, FIXED64)
    out[:, 3:11] = raw[:, 7::-1]         # upper: big- → little-endian
    out[:, 11] = 0x11                    # tag(2, FIXED64)
    out[:, 12:20] = raw[:, 15:7:-1]      # lower
    return out.tobytes()


def decode_uuid_records_raw(payloads: list) -> "np.ndarray | None":
    """Bulk decode of ``Uuid`` message payloads → ``[N, 16] uint8``
    big-endian UUID bytes, or ``None`` if any payload is non-canonical
    (zero half, unknown field, out-of-order fields) — callers then take
    the per-message path. The canonical record is the 18-byte layout
    :func:`encode_uuid_records` emits (and protoc/the reference's
    ``rust-protobuf`` emit, field order 1 then 2). The inverse pinned by
    ``tests/test_protos.py``.
    """
    n = len(payloads)
    a = np.frombuffer(b"".join(payloads), np.uint8)
    if a.size != 18 * n:
        return None
    a = a.reshape(-1, 18)
    if not ((a[:, 0] == 0x09).all() and (a[:, 9] == 0x11).all()):
        return None
    # little-endian wire halves → big-endian uuid bytes
    return np.concatenate([a[:, 8:0:-1], a[:, 17:9:-1]], axis=1)


def decode_string_run(buf: bytes, pos: int) -> "tuple[list[str], int]":
    """Bulk decode of a run of same-tag, same-length string records.

    ``buf[pos]`` must be a single-byte LEN tag whose length byte is
    < 128 (callers check ``key < 128``; the length check is here). Returns
    ``(strings, next_pos)`` for the maximal run of consecutive records
    sharing that exact (tag, length) prefix — equivalent to what the
    field-by-field parser would produce, since records are
    self-delimiting from ``pos`` and the run stops at the first record
    whose prefix differs (which the caller's serial loop then handles).
    Exists because a root manifest holds ~2·P 45-byte content-hash id
    records and the generic varint walk was ~80 % of ``load_database``.
    """
    n = len(buf)
    tag, length = buf[pos], buf[pos + 1] if pos + 1 < n else 0x80
    if length >= 128:           # 2-byte length varint: not a fixed record
        return [], pos
    rec = 2 + length
    avail = (n - pos) // rec
    if avail == 0:
        return [], pos
    # Strided bytes slices give the tag/length byte of every candidate
    # record in one C pass — the run is maximal where both match.
    end = pos + avail * rec
    tags = buf[pos:end:rec]
    lens = buf[pos + 1:end:rec]
    if tags == bytes([tag]) * avail and lens == bytes([length]) * avail:
        r = avail
    else:
        r = 0
        while r < avail and tags[r] == tag and lens[r] == length:
            r += 1
    if r == 0:
        return [], pos
    chunk = buf[pos:pos + r * rec]
    try:                        # hash ids are ASCII; slice one decoded str
        s = chunk.decode("ascii")
        strs = [s[i + 2:i + rec] for i in range(0, r * rec, rec)]
    except UnicodeDecodeError:  # arbitrary utf-8 (attribute names)
        strs = [decode_utf8(chunk[i + 2:i + rec], "string run")
                for i in range(0, r * rec, rec)]
    return strs, pos + r * rec


class Writer:
    """Accumulates encoded fields; fields must be appended in order."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def raw(self, data: bytes) -> None:
        self._parts.append(data)

    def varint_field(self, field: int, value: int) -> None:
        """Writes a varint field, skipping the proto3 default (0)."""
        if value:
            self._parts.append(tag(field, WT_VARINT))
            self._parts.append(encode_varint(value))

    def fixed64_field(self, field: int, value: int) -> None:
        if value:
            self._parts.append(tag(field, WT_FIXED64))
            self._parts.append(int(value).to_bytes(8, "little"))

    def len_field(self, field: int, payload: bytes) -> None:
        self._parts.append(tag(field, WT_LEN))
        self._parts.append(encode_varint(len(payload)))
        self._parts.append(payload)

    def string_field(self, field: int, value: str,
                     force: bool = False) -> None:
        """Skips empty strings unless ``force`` (oneof members always
        serialize)."""
        if value or force:
            self.len_field(field, value.encode("utf-8"))

    def message_field(self, field: int, message) -> None:
        if message is not None:
            self.len_field(field, message.encode())

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


def iter_fields(buf: bytes):
    """Yields ``(field, wire_type, value, payload)`` for each field.

    ``value`` is set for VARINT/FIXED64/FIXED32; ``payload`` for LEN.
    Unknown fields are the caller's to ignore — this parser just walks the
    buffer.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            value, pos = decode_varint(buf, pos)
            yield field, wt, value, None
        elif wt == WT_FIXED64:
            if pos + 8 > n:
                raise ProtobufError("truncated fixed64")
            yield field, wt, int.from_bytes(buf[pos:pos + 8], "little"), None
            pos += 8
        elif wt == WT_LEN:
            length, pos = decode_varint(buf, pos)
            if pos + length > n:
                raise ProtobufError("truncated length-delimited field")
            yield field, wt, None, buf[pos:pos + length]
            pos += length
        elif wt == WT_FIXED32:
            if pos + 4 > n:
                raise ProtobufError("truncated fixed32")
            yield field, wt, int.from_bytes(buf[pos:pos + 4], "little"), None
            pos += 4
        else:
            raise ProtobufError(f"unsupported wire type {wt}")
