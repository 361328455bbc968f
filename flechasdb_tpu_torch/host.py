"""The JAX package's jax-free host helpers that the slice needs, with the
same behaviour and messages: ``vector.as_vector_set``,
``metrics.check_metric``/``normalize_rows``, ``serving._choose_layout``
and ``stored.check_range_args``. A copy, for the reason given in
:mod:`.errors`; ``tests/test_torch_slice.py`` and
``tests/test_torch_range.py`` hold each against its original.
:func:`usable_cpus` is the port's own: the stored tier's pool sizes.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .errors import InvalidArgs

#: Accepted metric names. "" (absent wire field) means "l2".
VALID_METRICS = ("l2", "dot", "cosine")

#: Max tolerated padded-to-real ratio of the bucketed layout.
PAD_LIMIT = 4.0


def as_vector_set(data, vector_size: int | None = None) -> np.ndarray:
    """``data`` as a C-contiguous ``[N, M]`` float32 array: a 2-D array
    as it is, or a flat buffer chunked by ``vector_size``; wider floats and
    integers are cast with an overflow check (``vector.rs:40-57``)."""
    arr = np.asarray(data)
    if arr.dtype != np.float32:
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.integer)):
            raise InvalidArgs(f"unsupported vector dtype: {arr.dtype}")
        with np.errstate(over="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            cast = arr.astype(np.float32)
        if arr.dtype.itemsize > 4:
            bad = np.isinf(cast) & np.isfinite(
                arr.astype(np.float64, copy=False))
            if bad.any():
                raise InvalidArgs(
                    "vector values exceed the float32 range "
                    f"(first at flat index {int(np.flatnonzero(bad)[0])}); "
                    "the device path is f32 — rescale or use "
                    "flechasdb_tpu.oracle for an f64 host path")
        arr = cast
    if arr.ndim == 1:
        if vector_size is None:
            raise InvalidArgs("vector_size is required to chunk a flat buffer")
        if vector_size <= 0:
            raise InvalidArgs(f"vector_size must be positive: {vector_size}")
        if arr.size % vector_size != 0:
            raise InvalidArgs(
                f"data size ({arr.size}) is not a multiple of vector size"
                f" ({vector_size})")
        arr = arr.reshape(-1, vector_size)
    elif arr.ndim == 2:
        if vector_size is not None and arr.shape[1] != vector_size:
            raise InvalidArgs(
                f"vector_size {vector_size} does not match array width"
                f" {arr.shape[1]}")
    else:
        raise InvalidArgs(f"vector set must be 1-D or 2-D, got {arr.ndim}-D")
    return np.ascontiguousarray(arr)


def check_metric(metric: str) -> str:
    """Validates and canonicalizes a metric name ("" → "l2")."""
    m = metric or "l2"
    if m not in VALID_METRICS:
        raise InvalidArgs(
            f"unknown metric: {metric!r} (expected one of {VALID_METRICS})")
    return m


def normalize_rows(x: np.ndarray, what: str = "vector") -> np.ndarray:
    """Unit-normalizes rows for the cosine metric; zero rows are invalid."""
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    bad = np.nonzero(norms.reshape(-1) == 0)[0]
    if bad.size:
        raise InvalidArgs(
            f"cosine metric: {what} {int(bad[0])} has zero norm "
            "(no direction)")
    return (x / norms).astype(x.dtype, copy=False)


def bucket_len(counts) -> int:
    """Slots a bucket of the bucketed layout holds: the largest partition
    (at least 1) rounded up to 128, and above 2048 up to a multiple of
    1024, as the JAX package rounds it."""
    l = -(-max(int(np.max(counts, initial=0)), 1) // 128) * 128
    return -(-l // 1024) * 1024 if l > 2048 else l


def choose_layout(p: int, pidx: np.ndarray, n: int) -> str:
    """Bucketed unless partition skew pads the ``[P, L]`` buckets past
    :data:`PAD_LIMIT` times the corpus."""
    counts = np.bincount(pidx, minlength=p) if len(pidx) else [1]
    l_pad = bucket_len(counts)
    return "bucketed" if p * l_pad <= PAD_LIMIT * max(n, 128) else "masked"


def check_range_args(radius, nprobe: int, num_partitions: int) -> None:
    """``query_range``'s argument checks: a finite radius, and ``0 <
    nprobe <= num_partitions``."""
    if not np.isfinite(radius):
        raise InvalidArgs(f"radius must be finite: {radius}")
    if nprobe <= 0:
        raise InvalidArgs(f"nprobe must be positive: {nprobe}")
    if nprobe > num_partitions:
        raise InvalidArgs(
            f"nprobe {nprobe} exceeds the number of partitions"
            f" {num_partitions}")


def usable_cpus() -> int:
    """CPUs this process may run on: its schedulable set where the system
    reports one (a container or ``taskset`` limits it), else the
    machine's count. The stored tier sizes its thread pools from it."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return os.cpu_count() or 1
