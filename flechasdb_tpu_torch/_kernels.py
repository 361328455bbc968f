"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a``, one
``nvcc`` process a source, all started together, and the objects link
into ONE shared library with a plain C interface, loaded through
:mod:`ctypes`.
The build runs at the first launch (never at import: the package imports
on machines with no CUDA toolkit) into ``build/`` beside this file, under
a name keyed on the hash of the sources and of the ``csrc/*.cuh`` headers
they include, so an edited source or header rebuilds. As with
the JAX package's native IO runtime (``flechasdb_tpu/_native.py``), the
compiler writes a per-process temp name that is renamed into place, and a
file lock keeps concurrent first callers from racing two builds. A failed
build raises: there is no fallback.

Each C entry point takes ``c_void_p`` pointers and stream, launches on
the current device (the wrapper selects its tensors' device with
``torch.cuda.device``, which restores the caller's on leaving) and
returns ``cudaGetLastError()``; :func:`check` raises on anything but 0.
:data:`LAUNCHES` counts each wrapper's launches (:func:`launched`), so a
run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch

_SRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches per kernel since the last :func:`reset_launches`; the
#: fast_math variants of K-B and K-C count under their own keys, and the
#: cluster-sum pass that follows each of their rounds under
#: ``cluster_sums``, once a pass whichever route ran; the bucketed top-k's
#: two kernels under ``bucketed_topk``, once a pair; the probed
#: partitions' L2 tables under ``probed_tables``.
LAUNCHES = {"adc_scan": 0, "adc_lookup": 0, "lloyd_round": 0,
            "lloyd_grouped": 0, "lloyd_round_fast": 0,
            "lloyd_grouped_fast": 0, "cluster_sums": 0, "bucketed_topk": 0,
            "probed_tables": 0}

_lib: Optional[ctypes.CDLL] = None
#: The compiler's output of the build this process made (``None`` when the
#: library was already built).
build_log: Optional[str] = None
_lock = threading.Lock()
_launch_lock = threading.Lock()
#: The record :func:`recording` collects this thread's launches into.
_RECORDING = threading.local()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launched(name: str, n: int = 1) -> None:
    """Adds ``n`` launches of ``name`` to :data:`LAUNCHES`, or, inside
    :func:`recording` on this thread, to its record instead."""
    record = getattr(_RECORDING, "launches", None)
    if record is not None:
        record[name] = record.get(name, 0) + n
        return
    with _launch_lock:
        LAUNCHES[name] += n


@contextmanager
def recording():
    """Collects the launches this thread counts inside (:func:`launched`)
    into the dict it yields, ``{name: n}``, and adds none of them to
    :data:`LAUNCHES`: what a CUDA graph's capture launched, for its replays
    to count. Other threads count into :data:`LAUNCHES` meanwhile."""
    record = {}
    _RECORDING.launches = record
    try:
        yield record
    finally:
        _RECORDING.launches = None


def sources() -> list:
    return sorted(_SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_SRC_DIR.glob("*.cu*")):  # the .cu files and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libfdb_kernels-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    """Compiles each source in its own ``nvcc`` process, all at once, then
    links the objects; returns the compilers' output in source order."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = path.with_name(f"{path.name}.{os.getpid()}.objs")
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    try:
        objs.mkdir()
        procs = []
        for src in sources():
            obj = objs / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            try:
                out = proc.communicate(timeout=600)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0] + "\n(timed out)"
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *[str(o) for _, o, _ in procs]],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}"
                f"{res.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objs, ignore_errors=True)
    return "".join(log) + res.stdout + res.stderr


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fdb_adc_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fdb_adc_scan.restype = i
    lib.fdb_lloyd_round.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.fdb_lloyd_round.restype = i
    lib.fdb_lloyd_round_fast.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                         i, i, p]
    lib.fdb_lloyd_round_fast.restype = i
    lib.fdb_lloyd_grouped.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.fdb_lloyd_grouped.restype = i
    lib.fdb_lloyd_grouped_fast.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, p]
    lib.fdb_lloyd_grouped_fast.restype = i
    lib.fdb_cluster_sums.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     p]
    lib.fdb_cluster_sums.restype = i
    lib.fdb_cluster_sums_dense.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, i, i, i, p]
    lib.fdb_cluster_sums_dense.restype = i
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.fdb_cluster_sums_scratch.argtypes = [i, i, i, i, ll, ll]
    lib.fdb_cluster_sums_scratch.restype = None
    lib.fdb_bucketed_topk.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.fdb_bucketed_topk.restype = i
    lib.fdb_bucketed_topk_scratch.argtypes = [i, i, i]
    lib.fdb_bucketed_topk_scratch.restype = ctypes.c_longlong
    lib.fdb_probed_tables.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.fdb_probed_tables.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not path.exists():
                    build_log = _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
