"""Database format messages.

Wire-compatible with the reference schema (``src/protos/database.proto``) —
same field numbers, types, and nesting, so databases serialized by the
reference parse here and vice versa. Field-by-field:

* ``Database`` (proto:6-44): sizes (1-4), ``partition_ids`` (10),
  ``partition_centroids_id`` (11), ``codebook_ids`` (12),
  ``attributes_log_ids`` (13), ``attribute_names`` (14).
* ``Partition`` (proto:47-63): sizes (1-2), packed ``centroid`` (10),
  ``encoded_vectors`` message (11), repeated ``vector_ids`` (12).
* ``VectorSet`` / ``EncodedVectorSet`` (proto:66-85): ``vector_size`` (1),
  packed ``data`` (10) — f32 raw / u32 varints.
* ``AttributeValue`` (proto:88-93): oneof string (1) / uint64 (2).
* ``AttributesLog`` (proto:96-104): ``partition_id`` (1), ``entries`` (10).
* ``OperationSetAttribute`` (proto:107-115): ``vector_id`` (1),
  ``name_index`` (2), ``value`` (3).
* ``Uuid`` (proto:118-123): ``upper``/``lower`` fixed64 — the most/least
  significant halves of the 128-bit UUID.

Encoding follows canonical proto3: fields in number order, defaults skipped
(except oneof members), repeated scalars packed. Parsers accept packed and
unpacked forms and skip unknown fields.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field as dfield
from typing import List, Optional, Union

import numpy as np

from ..errors import ProtobufError
from . import wire
from .wire import Writer, iter_fields


def _expect_payload(payload: Optional[bytes], what: str) -> bytes:
    if payload is None:
        raise ProtobufError(f"{what}: expected length-delimited field")
    return payload


@dataclass
class PUuid:
    upper: int = 0
    lower: int = 0

    @classmethod
    def from_uuid(cls, u: _uuid.UUID) -> "PUuid":
        v = u.int
        return cls(upper=v >> 64, lower=v & ((1 << 64) - 1))

    def to_uuid(self) -> _uuid.UUID:
        return _uuid.UUID(int=(self.upper << 64) | self.lower)

    def encode(self) -> bytes:
        w = Writer()
        w.fixed64_field(1, self.upper)
        w.fixed64_field(2, self.lower)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PUuid":
        m = cls()
        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_FIXED64:
                m.upper = value
            elif f == 2 and wt == wire.WT_FIXED64:
                m.lower = value
        return m


@dataclass
class PVectorSet:
    """Flat f32 vector set; row i = data[i*vector_size:(i+1)*vector_size]."""
    vector_size: int = 0
    data: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        if len(self.data):
            w.len_field(10, wire.encode_packed_floats(self.data))
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PVectorSet":
        m = cls()
        parts: List[np.ndarray] = []
        pend: List[int] = []    # consecutive unpacked fixed32 scalars

        def flush() -> None:
            if pend:
                parts.append(np.frombuffer(
                    np.array(pend, np.uint32).tobytes(), "<f4").copy())
                pend.clear()

        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_VARINT:
                m.vector_size = value
            elif f == 10 and wt == wire.WT_LEN:
                flush()
                parts.append(wire.decode_packed_floats(
                    _expect_payload(payload, "VectorSet.data")))
            elif f == 10 and wt == wire.WT_FIXED32:
                pend.append(value)
        flush()
        if parts:
            m.data = wire.concat_repeated(parts)
        return m


@dataclass
class PEncodedVectorSet:
    """Flat u32 PQ-code set, same row layout as :class:`PVectorSet`."""
    vector_size: int = 0
    data: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.uint32))

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        if len(self.data):
            w.len_field(10, wire.encode_packed_u32(self.data))
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PEncodedVectorSet":
        m = cls()
        parts: List[np.ndarray] = []
        pend: List[int] = []    # consecutive unpacked varint scalars

        def flush() -> None:
            if pend:
                if max(pend) > 0xFFFFFFFF:
                    raise ProtobufError("uint32 overflow in unpacked field")
                parts.append(np.array(pend, np.uint32))
                pend.clear()

        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_VARINT:
                m.vector_size = value
            elif f == 10 and wt == wire.WT_LEN:
                flush()
                parts.append(wire.decode_packed_u32(
                    _expect_payload(payload, "EncodedVectorSet.data")))
            elif f == 10 and wt == wire.WT_VARINT:
                pend.append(value)
        flush()
        if parts:
            m.data = wire.concat_repeated(parts)
        return m


def _scan_uuid_tail(buf: bytes, tag: int) -> int:
    """Start offset of the longest suffix of ``buf`` made entirely of
    canonical 20-byte Uuid records for field tag byte ``tag`` (the layout
    every known writer emits: this serializer, protoc, the reference's
    rust-protobuf). All candidate tail starts are ≡ len(buf) (mod 20), so
    one vectorized pass suffices; callers accept the offset only if their
    field cursor lands exactly on it, which rules out look-alike bytes
    inside another field's payload. Returns ``len(buf)`` if no tail."""
    n = len(buf)
    if n < 20:
        return n
    a = np.frombuffer(buf, np.uint8)[n % 20:].reshape(-1, 20)
    ok = ((a[:, 0] == tag) & (a[:, 1] == 18)
          & (a[:, 2] == 0x09) & (a[:, 11] == 0x11))
    bad = np.nonzero(~ok)[0]
    first = (int(bad[-1]) + 1) if bad.size else 0
    if first < len(ok):
        return n % 20 + 20 * first
    return n


def _uuid_tail_records(buf: bytes, pos: int) -> np.ndarray:
    """``[N, 20] uint8`` record view of the tail starting at ``pos``."""
    return np.frombuffer(buf, np.uint8)[pos:].reshape(-1, 20)


def _uuid_tail_raw(rec: np.ndarray) -> np.ndarray:
    """Record view → ``[N, 16]`` big-endian UUID bytes (little-endian
    wire halves reversed)."""
    return np.concatenate([rec[:, 10:2:-1], rec[:, 19:11:-1]], axis=1)


def _materialize_puuids(ids_raw: np.ndarray) -> List["PUuid"]:
    return [
        PUuid(upper=int.from_bytes(r[:8].tobytes(), "big"),
              lower=int.from_bytes(r[8:].tobytes(), "big"))
        for r in ids_raw
    ]


class PPartition:
    """``Partition`` message.

    ``vector_ids`` is a lazily-materialized ``List[PUuid]``: ``decode``
    bulk-parses canonical Uuid records into a ``[L, 16] uint8`` array
    (``ids_raw``) and only builds the PUuid objects if the property is
    read — a 1,000-member partition spent ~3 ms/load in the per-message
    loop (the dominant cost of the reference-headline cold query,
    README.md:204), ~60 µs in bulk. Constructor/attribute surface is
    unchanged from the dataclass form.
    """

    def __init__(self, vector_size: int = 0, num_divisions: int = 0,
                 centroid: Optional[np.ndarray] = None,
                 encoded_vectors: Optional[PEncodedVectorSet] = None,
                 vector_ids: Optional[List[PUuid]] = None) -> None:
        self.vector_size = vector_size
        self.num_divisions = num_divisions
        self.centroid = (centroid if centroid is not None
                         else np.zeros(0, np.float32))
        self.encoded_vectors = encoded_vectors
        self._vector_ids: Optional[List[PUuid]] = (
            list(vector_ids) if vector_ids is not None else [])
        self._ids_raw: Optional[np.ndarray] = None

    @property
    def vector_ids(self) -> List[PUuid]:
        if self._vector_ids is None:
            self._vector_ids = _materialize_puuids(self._ids_raw)
        return self._vector_ids

    @vector_ids.setter
    def vector_ids(self, value: List[PUuid]) -> None:
        self._vector_ids = list(value)
        self._ids_raw = None

    @property
    def ids_raw(self) -> Optional[np.ndarray]:
        """``[L, 16] uint8`` big-endian UUID bytes when bulk-decoded."""
        return self._ids_raw

    @property
    def ids_count(self) -> int:
        if self._vector_ids is not None:
            return len(self._vector_ids)
        return len(self._ids_raw)

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        w.varint_field(2, self.num_divisions)
        if len(self.centroid):
            w.len_field(10, wire.encode_packed_floats(self.centroid))
        w.message_field(11, self.encoded_vectors)
        if self._vector_ids is None:
            w.raw(wire.encode_uuid_records(12, self._ids_raw))
        else:
            for vid in self._vector_ids:
                w.message_field(12, vid)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PPartition":
        m = cls()
        n = len(buf)
        # See _scan_uuid_tail: bulk-parse a canonical record tail, accept
        # only if the field cursor lands exactly on its start.
        tail_start = _scan_uuid_tail(buf, (12 << 3) | wire.WT_LEN)
        id_payloads: List[bytes] = []
        cent_parts: List[np.ndarray] = []   # repeated-field merge: concat
        cent_pend: List[int] = []
        ev_payloads: List[bytes] = []       # message merge = concat-decode
        decode_varint = wire.decode_varint
        pos = 0
        while pos < n:
            if pos == tail_start:
                rec = _uuid_tail_records(buf, pos)
                if id_payloads:     # records preceded by odd ids: merge
                    id_payloads.extend(bytes(r[2:]) for r in rec)
                else:
                    m._vector_ids, m._ids_raw = None, _uuid_tail_raw(rec)
                pos = n
                break
            key, pos = decode_varint(buf, pos)
            f, wt = key >> 3, key & 7
            if wt == wire.WT_VARINT:
                value, pos = decode_varint(buf, pos)
                if f == 1:
                    m.vector_size = value
                elif f == 2:
                    m.num_divisions = value
            elif wt == wire.WT_LEN:
                length, pos = decode_varint(buf, pos)
                if pos + length > n:
                    raise ProtobufError("truncated length-delimited field")
                payload = buf[pos:pos + length]
                pos += length
                if f == 10:
                    if cent_pend:
                        cent_parts.append(np.frombuffer(np.array(
                            cent_pend, np.uint32).tobytes(),
                            "<f4").copy())
                        cent_pend.clear()
                    cent_parts.append(wire.decode_packed_floats(payload))
                elif f == 11:
                    ev_payloads.append(payload)
                elif f == 12:
                    id_payloads.append(payload)
            elif wt == wire.WT_FIXED64:
                if pos + 8 > n:
                    raise ProtobufError("truncated fixed64")
                pos += 8
            elif wt == wire.WT_FIXED32:
                if pos + 4 > n:
                    raise ProtobufError("truncated fixed32")
                if f == 10:     # unpacked centroid element
                    cent_pend.append(
                        int.from_bytes(buf[pos:pos + 4], "little"))
                pos += 4
            else:
                raise ProtobufError(f"unsupported wire type {wt}")
        if cent_pend:
            cent_parts.append(np.frombuffer(
                np.array(cent_pend, np.uint32).tobytes(), "<f4").copy())
        if cent_parts:
            m.centroid = wire.concat_repeated(cent_parts)
        if ev_payloads:
            # Singular-message merge: parsing the concatenation of all
            # occurrences' payloads == proto3 field-by-field merge.
            m.encoded_vectors = PEncodedVectorSet.decode(
                b"".join(ev_payloads))
        if id_payloads:
            raw = wire.decode_uuid_records_raw(id_payloads)
            if raw is not None:
                m._vector_ids, m._ids_raw = None, raw
            else:  # zero half / unusual field layout: per-message path
                m._vector_ids = [PUuid.decode(p) for p in id_payloads]
        return m


@dataclass
class PAttributeValue:
    """oneof: exactly one of string_value / uint64_value."""
    value: Union[str, int, None] = None

    def encode(self) -> bytes:
        w = Writer()
        if isinstance(self.value, str):
            w.string_field(1, self.value, force=True)
        elif isinstance(self.value, int):
            # oneof members serialize even at default value
            w.raw(wire.tag(2, wire.WT_VARINT))
            w.raw(wire.encode_varint(self.value))
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PAttributeValue":
        m = cls()
        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_LEN:
                m.value = wire.decode_utf8(_expect_payload(
                    payload, "AttributeValue"), "AttributeValue")
            elif f == 2 and wt == wire.WT_VARINT:
                m.value = value
        return m


@dataclass
class POperationSetAttribute:
    vector_id: Optional[PUuid] = None
    name_index: int = 0
    value: Optional[PAttributeValue] = None

    def encode(self) -> bytes:
        w = Writer()
        w.message_field(1, self.vector_id)
        w.varint_field(2, self.name_index)
        w.message_field(3, self.value)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "POperationSetAttribute":
        m = cls()
        vid_p: List[bytes] = []     # message merge = concat-decode
        val_p: List[bytes] = []
        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_LEN:
                vid_p.append(_expect_payload(payload, "vector_id"))
            elif f == 2 and wt == wire.WT_VARINT:
                m.name_index = value
            elif f == 3 and wt == wire.WT_LEN:
                val_p.append(_expect_payload(payload, "value"))
        if vid_p:
            m.vector_id = PUuid.decode(b"".join(vid_p))
        if val_p:
            m.value = PAttributeValue.decode(b"".join(val_p))
        return m


@dataclass
class PAttributesLog:
    """Set-operation log; replay order matters (last write wins)."""
    partition_id: str = ""
    entries: List[POperationSetAttribute] = dfield(default_factory=list)

    def encode(self) -> bytes:
        w = Writer()
        w.string_field(1, self.partition_id)
        for e in self.entries:
            w.message_field(10, e)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PAttributesLog":
        m = cls()
        for f, wt, value, payload in iter_fields(buf):
            if f == 1 and wt == wire.WT_LEN:
                m.partition_id = wire.decode_utf8(_expect_payload(
                    payload, "partition_id"), "partition_id")
            elif f == 10 and wt == wire.WT_LEN:
                m.entries.append(POperationSetAttribute.decode(
                    _expect_payload(payload, "entries")))
        return m


@dataclass
class PDatabase:
    vector_size: int = 0
    num_partitions: int = 0
    num_divisions: int = 0
    num_codes: int = 0
    partition_ids: List[str] = dfield(default_factory=list)
    partition_centroids_id: str = ""
    codebook_ids: List[str] = dfield(default_factory=list)
    attributes_log_ids: List[str] = dfield(default_factory=list)
    attribute_names: List[str] = dfield(default_factory=list)
    #: EXTENSION (field 20, absent in the reference schema): reference ID of
    #: the OPQ rotation VectorSet. Databases with a rotation are NOT
    #: readable by the reference (it would skip the unknown field and decode
    #: codes without rotating the query residuals).
    rotation_id: str = ""
    #: EXTENSION (field 21): query metric name — "" (= "l2", the
    #: reference's), "dot" or "cosine" (see ``metrics.py``). The reference
    #: would skip the unknown field and serve the index as L2.
    metric: str = ""

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        w.varint_field(2, self.num_partitions)
        w.varint_field(3, self.num_divisions)
        w.varint_field(4, self.num_codes)
        for s in self.partition_ids:
            w.string_field(10, s, force=True)
        w.string_field(11, self.partition_centroids_id)
        for s in self.codebook_ids:
            w.string_field(12, s, force=True)
        for s in self.attributes_log_ids:
            w.string_field(13, s, force=True)
        for s in self.attribute_names:
            w.string_field(14, s, force=True)
        w.string_field(20, self.rotation_id)
        w.string_field(21, self.metric)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PDatabase":
        m = cls()
        # The repeated-id fields (2·P + D content-hash strings) decode as
        # bulk same-prefix record runs — the generic field walk was ~80 %
        # of load_database (see wire.decode_string_run). Non-run fields
        # fall through to the serial cursor below, so any interleaving or
        # unusual writer layout still parses.
        runs = {10: "partition_ids", 12: "codebook_ids",
                13: "attributes_log_ids", 14: "attribute_names"}
        decode_varint = wire.decode_varint
        pos, n = 0, len(buf)
        while pos < n:
            tag_pos = pos
            key, pos = decode_varint(buf, pos)
            f, wt = key >> 3, key & 7
            if wt == wire.WT_LEN:
                if f in runs and key < 128:
                    strs, end = wire.decode_string_run(buf, tag_pos)
                    if strs:
                        getattr(m, runs[f]).extend(strs)
                        pos = end
                        continue
                length, pos = decode_varint(buf, pos)
                if pos + length > n:
                    raise ProtobufError("truncated length-delimited field")
                payload = buf[pos:pos + length]
                pos += length
                if f == 11:
                    m.partition_centroids_id = wire.decode_utf8(payload)
                elif f == 20:
                    m.rotation_id = wire.decode_utf8(payload)
                elif f == 21:
                    m.metric = wire.decode_utf8(payload)
                elif f in runs:     # 2-byte length (>127-char string)
                    getattr(m, runs[f]).append(wire.decode_utf8(payload))
            elif wt == wire.WT_VARINT:
                value, pos = decode_varint(buf, pos)
                if f == 1:
                    m.vector_size = value
                elif f == 2:
                    m.num_partitions = value
                elif f == 3:
                    m.num_divisions = value
                elif f == 4:
                    m.num_codes = value
            elif wt == wire.WT_FIXED64:
                if pos + 8 > n:
                    raise ProtobufError("truncated fixed64")
                pos += 8
            elif wt == wire.WT_FIXED32:
                if pos + 4 > n:
                    raise ProtobufError("truncated fixed32")
                pos += 4
            else:
                raise ProtobufError(f"unsupported wire type {wt}")
        return m


# --- flechasdb-tpu extensions (not part of the reference format) -----------
#
# "Flat database" is an open roadmap item in the reference (README.md:74);
# these messages define its storage: raw vectors in content-addressed
# chunks, the same Uuid/AttributesLog machinery, a dedicated root manifest.


class PFlatChunk:
    """One chunk of raw vectors with their IDs (extension message).

    Same lazy bulk-Uuid machinery as :class:`PPartition` (field 11 is the
    message's last field): a 100k-row flat chunk decodes its ids in one
    vectorized pass instead of ~4 µs/record through the field walk."""

    def __init__(self, vector_size: int = 0,
                 vectors: Optional[PVectorSet] = None,
                 vector_ids: Optional[List[PUuid]] = None,
                 ids_raw: Optional[np.ndarray] = None) -> None:
        self.vector_size = vector_size
        self.vectors = vectors
        if ids_raw is not None:
            self._vector_ids: Optional[List[PUuid]] = None
            self._ids_raw: Optional[np.ndarray] = ids_raw
        else:
            self._vector_ids = (list(vector_ids)
                                if vector_ids is not None else [])
            self._ids_raw = None

    @property
    def vector_ids(self) -> List[PUuid]:
        if self._vector_ids is None:
            self._vector_ids = _materialize_puuids(self._ids_raw)
        return self._vector_ids

    @vector_ids.setter
    def vector_ids(self, value: List[PUuid]) -> None:
        self._vector_ids = list(value)
        self._ids_raw = None

    @property
    def ids_raw(self) -> Optional[np.ndarray]:
        """``[N, 16] uint8`` big-endian UUID bytes when bulk-decoded."""
        return self._ids_raw

    @property
    def ids_count(self) -> int:
        if self._vector_ids is not None:
            return len(self._vector_ids)
        return len(self._ids_raw)

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        w.message_field(10, self.vectors)
        if self._vector_ids is None:
            w.raw(wire.encode_uuid_records(11, self._ids_raw))
        else:
            for vid in self._vector_ids:
                w.message_field(11, vid)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PFlatChunk":
        m = cls()
        n = len(buf)
        tail_start = _scan_uuid_tail(buf, (11 << 3) | wire.WT_LEN)
        id_payloads: List[bytes] = []
        vec_payloads: List[bytes] = []      # message merge = concat-decode
        decode_varint = wire.decode_varint
        pos = 0
        while pos < n:
            if pos == tail_start:
                rec = _uuid_tail_records(buf, pos)
                if id_payloads:     # records preceded by odd ids: merge
                    id_payloads.extend(bytes(r[2:]) for r in rec)
                else:
                    m._vector_ids, m._ids_raw = None, _uuid_tail_raw(rec)
                pos = n
                break
            key, pos = decode_varint(buf, pos)
            f, wt = key >> 3, key & 7
            if wt == wire.WT_VARINT:
                value, pos = decode_varint(buf, pos)
                if f == 1:
                    m.vector_size = value
            elif wt == wire.WT_LEN:
                length, pos = decode_varint(buf, pos)
                if pos + length > n:
                    raise ProtobufError("truncated length-delimited field")
                payload = buf[pos:pos + length]
                pos += length
                if f == 10:
                    vec_payloads.append(payload)
                elif f == 11:
                    id_payloads.append(payload)
            elif wt == wire.WT_FIXED64:
                if pos + 8 > n:
                    raise ProtobufError("truncated fixed64")
                pos += 8
            elif wt == wire.WT_FIXED32:
                if pos + 4 > n:
                    raise ProtobufError("truncated fixed32")
                pos += 4
            else:
                raise ProtobufError(f"unsupported wire type {wt}")
        if vec_payloads:
            # Singular-message merge: parsing the concatenation of all
            # occurrences' payloads == proto3 field-by-field merge.
            m.vectors = PVectorSet.decode(b"".join(vec_payloads))
        if id_payloads:
            raw = wire.decode_uuid_records_raw(id_payloads)
            if raw is not None:
                m._vector_ids, m._ids_raw = None, raw
            else:  # zero half / unusual field layout: per-message path
                m._vector_ids = [PUuid.decode(p) for p in id_payloads]
        return m


@dataclass
class PFlatDatabase:
    """Root manifest of a flat (exact-search) database (extension)."""
    vector_size: int = 0
    num_vectors: int = 0
    chunk_ids: List[str] = dfield(default_factory=list)
    attributes_log_ids: List[str] = dfield(default_factory=list)
    attribute_names: List[str] = dfield(default_factory=list)
    #: Query metric ("" = "l2"); same contract as PDatabase.metric.
    metric: str = ""

    def encode(self) -> bytes:
        w = Writer()
        w.varint_field(1, self.vector_size)
        w.varint_field(2, self.num_vectors)
        for s in self.chunk_ids:
            w.string_field(10, s, force=True)
        for s in self.attributes_log_ids:
            w.string_field(11, s, force=True)
        for s in self.attribute_names:
            w.string_field(12, s, force=True)
        w.string_field(21, self.metric)
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "PFlatDatabase":
        m = cls()
        for f, wt, value, payload in iter_fields(buf):
            if wt == wire.WT_VARINT:
                if f == 1:
                    m.vector_size = value
                elif f == 2:
                    m.num_vectors = value
            elif wt == wire.WT_LEN:
                if f == 10:
                    m.chunk_ids.append(wire.decode_utf8(payload))
                elif f == 11:
                    m.attributes_log_ids.append(wire.decode_utf8(payload))
                elif f == 12:
                    m.attribute_names.append(wire.decode_utf8(payload))
                elif f == 21:
                    m.metric = wire.decode_utf8(payload)
        return m
