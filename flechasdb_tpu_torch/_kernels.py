"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded through :mod:`ctypes`.
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
:data:`LAUNCHES` counts each wrapper's launches, so a run can show that
the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_SRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"adc_scan": 0, "adc_lookup": 0, "lloyd_round": 0,
            "lloyd_grouped": 0}

_lib: Optional[ctypes.CDLL] = None
#: The compiler's output of the build this process made (``None`` when the
#: library was already built).
build_log: Optional[str] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return res.stdout + res.stderr


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fdb_adc_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fdb_adc_scan.restype = i
    lib.fdb_lloyd_round.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.fdb_lloyd_round.restype = i
    lib.fdb_lloyd_grouped.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.fdb_lloyd_grouped.restype = i


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
