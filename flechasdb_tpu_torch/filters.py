"""Attribute filters (the JAX package's ``filters.py``).

A predicate over per-vector attributes compiles on the host into one
boolean row mask ``[N]`` (vectorized numpy over cached attribute columns);
the query uploads it once and drops masked rows (``+inf``) before the
top-k, so results are the k nearest *matching* vectors reachable through
the probed partitions. Filters compose with ``&``, ``|`` and ``~``::

    from flechasdb_tpu_torch.filters import Eq, Range
    db.query_batch(q, k=10, nprobe=8, where=Eq("color", "red")
                                            & Range("price", hi=100))

Predicates (attribute values are str or uint64, :mod:`.attributes`):
:class:`Eq`, :class:`In`, :class:`Range` (uint64 only), :class:`Exists`.

The port keeps its own copy, with the same classes, semantics and
messages, for the reason given in :mod:`.errors`;
``tests/test_torch_filters.py`` holds it against the original.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .attributes import AttributeTable
from .errors import InvalidArgs

__all__ = ["Filter", "Eq", "In", "Range", "Exists",
           "And", "Or", "Not", "evaluate_mask", "ColumnCache"]


class Filter:
    """Base predicate; combine with ``&`` (and), ``|`` (or), ``~`` (not)."""

    def __and__(self, other: "Filter") -> "Filter":
        return And(self, _check_filter(other))

    def __or__(self, other: "Filter") -> "Filter":
        return Or(self, _check_filter(other))

    def __invert__(self) -> "Filter":
        return Not(self)


def _check_filter(f) -> "Filter":
    if not isinstance(f, Filter):
        raise InvalidArgs(f"not a Filter: {f!r}")
    return f


def _check_key(key) -> str:
    if not isinstance(key, str) or not key:
        raise InvalidArgs(f"attribute key must be a non-empty str: {key!r}")
    return key


def _check_value(v):
    if isinstance(v, bool) or not isinstance(v, (str, int)):
        raise InvalidArgs(
            f"attribute values are str or uint64: {v!r}")
    if isinstance(v, int) and not 0 <= v < 2 ** 64:
        raise InvalidArgs(f"uint64 out of range: {v}")
    return v


@dataclass(frozen=True)
class Eq(Filter):
    """``attrs[key] == value`` (missing attribute → no match)."""
    key: str
    value: object

    def __post_init__(self):
        _check_key(self.key)
        _check_value(self.value)


@dataclass(frozen=True)
class In(Filter):
    """``attrs[key] ∈ values``."""
    key: str
    values: Tuple[object, ...]

    def __init__(self, key: str, values) -> None:
        object.__setattr__(self, "key", _check_key(key))
        vals = tuple(values)
        if not vals:
            raise InvalidArgs("In() needs at least one value")
        for v in vals:
            _check_value(v)
        object.__setattr__(self, "values", vals)


@dataclass(frozen=True)
class Range(Filter):
    """``lo <= attrs[key] <= hi`` over uint64 values (bounds inclusive,
    either may be omitted). String-valued attributes never match."""
    key: str
    lo: object = None
    hi: object = None

    def __post_init__(self):
        _check_key(self.key)
        if self.lo is None and self.hi is None:
            raise InvalidArgs("Range() needs lo and/or hi")
        for b in (self.lo, self.hi):
            if b is not None and (isinstance(b, bool)
                                  or not isinstance(b, int)):
                raise InvalidArgs(f"Range bounds are uint64: {b!r}")
            if b is not None and not 0 <= b < 2 ** 64:
                raise InvalidArgs(f"uint64 out of range: {b}")


@dataclass(frozen=True)
class Exists(Filter):
    """The vector has attribute ``key`` (any value)."""
    key: str

    def __post_init__(self):
        _check_key(self.key)


@dataclass(frozen=True)
class And(Filter):
    a: Filter
    b: Filter


@dataclass(frozen=True)
class Or(Filter):
    a: Filter
    b: Filter


@dataclass(frozen=True)
class Not(Filter):
    a: Filter


class _Column:
    """Columnar view of one attribute across the corpus rows."""

    __slots__ = ("present", "is_int", "ints", "strs")

    def __init__(self, n: int) -> None:
        self.present = np.zeros(n, bool)
        self.is_int = np.zeros(n, bool)
        self.ints = np.zeros(n, np.uint64)
        self.strs = np.full(n, "", object)


class ColumnCache:
    """Caches attribute columns keyed by attribute name.

    Built once per (attribute key, corpus version): O(N) Python on first
    use of a key, then every filter over that key is vectorized numpy.
    Owners must call :meth:`invalidate` whenever vectors or attributes
    change (``Database.set_attribute_at`` / ``add_vectors`` /
    ``remove_vectors`` do).
    """

    def __init__(self) -> None:
        self._columns: Dict[str, _Column] = {}

    def invalidate(self) -> None:
        self._columns.clear()

    def column(self, key: str, ids: List[_uuid.UUID],
               table: AttributeTable) -> _Column:
        col = self._columns.get(key)
        if col is None:
            col = _Column(len(ids))
            for i, vid in enumerate(ids):
                attrs = table.get(vid)
                if not attrs:
                    continue
                v = attrs.get(key)
                if v is None:
                    continue
                col.present[i] = True
                if isinstance(v, int):
                    col.is_int[i] = True
                    col.ints[i] = v
                else:
                    col.strs[i] = v
            self._columns[key] = col
        return col


def evaluate_mask(filt: Filter, ids: List[_uuid.UUID],
                  table: AttributeTable,
                  cache: ColumnCache) -> np.ndarray:
    """Evaluates ``filt`` to a boolean row mask ``[len(ids)]``."""
    _check_filter(filt)
    if isinstance(filt, And):
        return (evaluate_mask(filt.a, ids, table, cache)
                & evaluate_mask(filt.b, ids, table, cache))
    if isinstance(filt, Or):
        return (evaluate_mask(filt.a, ids, table, cache)
                | evaluate_mask(filt.b, ids, table, cache))
    if isinstance(filt, Not):
        return ~evaluate_mask(filt.a, ids, table, cache)

    col = cache.column(filt.key, ids, table)
    if isinstance(filt, Exists):
        return col.present.copy()
    if isinstance(filt, Eq):
        if isinstance(filt.value, int):
            return col.is_int & (col.ints == np.uint64(filt.value))
        return col.present & ~col.is_int & (col.strs == filt.value)
    if isinstance(filt, In):
        ints = [v for v in filt.values if isinstance(v, int)]
        strs = [v for v in filt.values if isinstance(v, str)]
        mask = np.zeros(len(ids), bool)
        if ints:
            mask |= col.is_int & np.isin(
                col.ints, np.asarray(ints, np.uint64))
        if strs:
            mask |= (col.present & ~col.is_int
                     & np.isin(col.strs.astype(object), np.asarray(
                         strs, object)))
        return mask
    if isinstance(filt, Range):
        mask = col.is_int.copy()
        if filt.lo is not None:
            mask &= col.ints >= np.uint64(filt.lo)
        if filt.hi is not None:
            mask &= col.ints <= np.uint64(filt.hi)
        return mask
    raise InvalidArgs(f"unknown filter type: {type(filt).__name__}")
