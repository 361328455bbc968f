"""ctypes bindings to the native IO runtime (``native/fastio.cc``).

A copy of the JAX package's ``_native.py`` over the port's own copy of
``fastio.cc``, for the reason given in :mod:`.errors`. The reference's
storage layer is native (``src/io.rs``: streaming SHA-256 under a zlib
encoder). This module loads the C++ equivalent and exposes
``pack``/``unpack``/``hash_name`` and the host ADC helpers; when the shared
library is absent it is built on the fly with ``g++`` into ``build/``
beside this file (best effort), and if that fails the callers in
:mod:`.io`, :mod:`.protos` and :mod:`.stored` use Python's zlib/hashlib and
numpy instead, which give the same bytes and results, slower and bound by
the interpreter lock. This is host code, not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_LIB_PATH = Path(__file__).parent / "build" / "libflechas_io.so"
#: Canonical source ships INSIDE the package (sdist/wheel data), so an
#: installed copy can auto-build the runtime at first import exactly like
#: a repo checkout; when g++ or the source is absent, every caller falls
#: back to the pure-Python zlib/hashlib/numpy paths.
_SRC_PATH = Path(__file__).parent / "native" / "fastio.cc"

_lib: Optional[ctypes.CDLL] = None
_tried = False
#: Serializes first-load (and any rebuild): concurrent first callers —
#: e.g. the codebook/prefetch thread pools — must not race two g++
#: compiles into one output file.
_load_lock = threading.Lock()


def _build() -> bool:
    # Compile to a per-pid temp name and atomically rename: a concurrent
    # importer must never dlopen a partially written .so.
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}")
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
             "-o", str(tmp), str(_SRC_PATH), "-lz"],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _load_lock:
        if _tried:                # lost the race: first loader already won
            return _lib
        lib = _load_locked()
        _lib = lib
        _tried = True             # set LAST: racers must not read early
        return lib


def _load_locked() -> Optional[ctypes.CDLL]:
    if _SRC_PATH.exists():
        try:
            stale = (_LIB_PATH.exists() and _LIB_PATH.stat().st_mtime
                     < _SRC_PATH.stat().st_mtime)
        except OSError:
            stale = False
        if stale or not _LIB_PATH.exists():
            _build()
    if not _LIB_PATH.exists():
        return None
    lib = _bind(_LIB_PATH)
    if lib is None and _SRC_PATH.exists() and _build():
        # A cached .so from an older source may predate symbols bound
        # below (it is gitignored and otherwise only built when absent);
        # one rebuild-and-retry, then give up to the Python fallbacks.
        lib = _bind(_LIB_PATH)
    return lib


def _bind(path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    try:
        _declare(lib)
    except AttributeError:          # missing symbol: stale library
        return None
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.fio_hash.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.c_char_p]
    lib.fio_hash.restype = None
    lib.fio_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    lib.fio_pack.restype = ctypes.c_int
    lib.fio_unpack.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    lib.fio_unpack.restype = ctypes.c_int
    lib.fio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.fio_free.restype = None
    lib.fio_adc_sum.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_size_t,
                                ctypes.c_size_t, ctypes.c_void_p]
    lib.fio_adc_sum.restype = None
    lib.fio_topk_f32.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_size_t, ctypes.c_void_p]
    lib.fio_topk_f32.restype = ctypes.c_size_t
    lib.fio_adc_topk.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_size_t, ctypes.c_size_t,
                                 ctypes.c_size_t, ctypes.c_float,
                                 ctypes.c_size_t, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.fio_adc_topk.restype = ctypes.c_size_t
    lib.fio_adc_topk_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fio_adc_topk_batch.restype = None
    lib.fio_varint_u32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_void_p]
    lib.fio_varint_u32.restype = ctypes.c_size_t


def available() -> bool:
    """True when the native runtime is loaded (or buildable)."""
    return _load() is not None


def hash_name(data: bytes) -> Optional[str]:
    """URL-safe-base64 SHA-256 of ``data``; None if native IO unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(44)
    lib.fio_hash(data, len(data), out)
    return out.value.decode("ascii")


def pack(payload: bytes, compress: bool,
         level: int = 6) -> Optional[tuple[bytes, str]]:
    """One-pass (deflate +) hash. Returns ``(stored_bytes, hash)``."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    hash_buf = ctypes.create_string_buffer(44)
    rc = lib.fio_pack(payload, len(payload), level if compress else 0,
                      ctypes.byref(out), ctypes.byref(out_len), hash_buf)
    if rc != 0:
        raise MemoryError(f"fio_pack failed: {rc}")
    try:
        stored = ctypes.string_at(out, out_len.value)
    finally:
        lib.fio_free(out)
    return stored, hash_buf.value.decode("ascii")


def adc_sum(table, codes) -> "Optional[object]":
    """``out[l] = sum_d table[d, codes[l, d]]`` — the ADC gather-accumulate
    of the host query path (db/stored.rs:576-595). ``table`` is ``[D, C]``
    f32 C-contiguous, ``codes`` ``[L, D]`` uint32 C-contiguous. None if
    native IO is unavailable (caller falls back to numpy fancy indexing).
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    if not (table.dtype == np.float32 and table.flags.c_contiguous
            and codes.dtype == np.uint32 and codes.flags.c_contiguous):
        return None
    rows, d = codes.shape
    out = np.empty(rows, np.float32)
    lib.fio_adc_sum(table.ctypes.data, codes.ctypes.data,
                    rows, d, table.shape[1], out.ctypes.data)
    return out


def adc_topk(table, qnorm: float, codes, k: int) -> "Optional[object]":
    """Fused ADC scan + k-best: one pass over ``codes [L, D]`` accumulating
    ``qnorm + sum_d table[d, codes[l, d]]`` into a k-bounded heap. Returns
    ``(order, dists_selected)`` — identical to
    ``topk_stable(adc_sum(table, codes) + qnorm, k)`` plus the selected
    distances — without materializing the L-sized distance array or paying
    a second ctypes crossing. None if native IO is unavailable or the
    layouts don't match (caller falls back to the two-step path)."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    if not (table.dtype == np.float32 and table.flags.c_contiguous
            and codes.dtype == np.uint32 and codes.flags.c_contiguous):
        return None
    rows, d = codes.shape
    kk = min(k, rows)
    out_idx = np.empty(kk, np.uint32)
    out_dist = np.empty(kk, np.float32)
    got = lib.fio_adc_topk(table.ctypes.data, codes.ctypes.data,
                           rows, d, table.shape[1], float(qnorm), k,
                           out_idx.ctypes.data, out_dist.ctypes.data)
    return out_idx[:got], out_dist[:got]


def adc_topk_batch(tables, qnorms, codes_list, k: int) -> "Optional[object]":
    """All nprobe partition scans of one query in ONE ctypes crossing.

    ``tables [n, D, C]`` f32 C-contiguous (the batched-GEMM output of
    ``stored.adc_tables``), ``qnorms [n]`` f32, ``codes_list`` a sequence of
    n ``[L_i, D]`` uint32 C-contiguous code matrices. Returns
    ``(idx [n, k] uint32, dist [n, k] f32, cnt [n] int)`` where row i's
    first ``cnt[i]`` entries are partition i's k-best (ascending, stable) —
    exactly n independent :func:`adc_topk` calls. None when native IO is
    unavailable or any layout doesn't match (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    n, d, c = tables.shape
    if not (tables.dtype == np.float32 and tables.flags.c_contiguous
            and len(codes_list) == n):
        return None
    ptrs = (ctypes.c_void_p * n)()
    rows = (ctypes.c_size_t * n)()
    for i, codes in enumerate(codes_list):
        if not (codes.dtype == np.uint32 and codes.flags.c_contiguous
                and codes.ndim == 2 and codes.shape[1] == d):
            return None
        ptrs[i] = codes.ctypes.data
        rows[i] = codes.shape[0]
    qn = np.ascontiguousarray(qnorms, np.float32)
    out_idx = np.empty((n, k), np.uint32)
    out_dist = np.empty((n, k), np.float32)
    out_cnt = np.empty(n, np.uint32)
    lib.fio_adc_topk_batch(tables.ctypes.data, qn.ctypes.data,
                           ctypes.addressof(ptrs), ctypes.addressof(rows),
                           n, d, c, k,
                           out_idx.ctypes.data, out_dist.ctypes.data,
                           out_cnt.ctypes.data)
    return out_idx, out_dist, out_cnt


def topk_f32(dists, k: int) -> "Optional[object]":
    """Indices of the ``k`` smallest (ascending, stable tie-break — the
    same prefix a stable argsort yields). ``dists`` is f32 C-contiguous
    and NaN-free (``inf`` is fine). None if native IO is unavailable."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    if not (dists.dtype == np.float32 and dists.flags.c_contiguous):
        return None
    out = np.empty(min(k, len(dists)), np.uint32)
    got = lib.fio_topk_f32(dists.ctypes.data, len(dists), k,
                           out.ctypes.data)
    return out[:got]


def varint_u32(payload: bytes) -> "Optional[object]":
    """Packed ``repeated uint32`` varint decode (protobuf wire format).
    Returns a uint32 array, or None when native IO is unavailable OR the
    payload is malformed — the caller's vectorized numpy decoder then
    reproduces the exact ProtobufError."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    out = np.empty(len(payload), np.uint32)
    got = lib.fio_varint_u32(payload, len(payload), out.ctypes.data)
    if got == ctypes.c_size_t(-1).value:
        return None
    # copy, not a view: a view would pin the full len(payload)-sized
    # scratch buffer for the lifetime of the cached partition codes
    # (~1.5x resident memory at C=256, where most varints are 2 bytes).
    return out[:got].copy()


def unpack(stored: bytes, compressed: bool,
           need_hash: bool = True) -> Optional[tuple[bytes, Optional[str]]]:
    """One-pass hash (+ inflate). Returns ``(payload, hash_of_stored)``.

    ``need_hash=False`` skips the SHA pass (hash comes back None) — for
    artifacts whose verification the caller skips (the sync stored path's
    centroid/attr-log quirk), hashing is pure waste.

    Raises ``ValueError`` on a corrupt deflate stream.
    """
    lib = _load()
    if lib is None:
        return None
    if not compressed:
        if not need_hash:
            return stored, None
        # Hash-only: the stored bytes ARE the payload — skip the C-side
        # copy + ctypes copy-out (2 payload-sized memcpys for nothing).
        hash_buf = ctypes.create_string_buffer(44)
        lib.fio_hash(stored, len(stored), hash_buf)
        return stored, hash_buf.value.decode("ascii")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    hash_buf = ctypes.create_string_buffer(44) if need_hash else None
    rc = lib.fio_unpack(stored, len(stored), 1 if compressed else 0,
                        ctypes.byref(out), ctypes.byref(out_len), hash_buf)
    if rc == -2:
        raise ValueError("corrupt deflate stream")
    if rc != 0:
        raise MemoryError(f"fio_unpack failed: {rc}")
    try:
        payload = ctypes.string_at(out, out_len.value)
    finally:
        lib.fio_free(out)
    return payload, (hash_buf.value.decode("ascii") if need_hash else None)
