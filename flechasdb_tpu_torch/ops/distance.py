"""Pairwise squared distances (the JAX package's ``ops/distance.py``).

``‖a − b‖² = ‖a‖² + ‖b‖² − 2 a·b`` with the cross term as an f32 matrix
product. TF32 keeps about three decimal digits, too few for top-k and
argmin ranking, so every cuBLAS product that ranks runs under
:func:`full_f32`, whatever TF32 setting the process chose (the JAX
package pins ``Precision.HIGHEST`` the same way).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Full-f32 (IEEE) cuBLAS matmuls within; the process's own setting is
    restored on leaving. Usable as a decorator.

    It speaks the API the process spoke: the global one
    (``set_float32_matmul_precision``, ``allow_tf32``) keeps both of
    PyTorch's settings in step, and its getter refuses to read once the
    process set the per-backend ``fp32_precision`` (PyTorch >= 2.9)."""
    mm = torch.backends.cuda.matmul
    try:
        prev = torch.get_float32_matmul_precision()
        full, put = "highest", torch.set_float32_matmul_precision
    except RuntimeError:
        prev, full = mm.fp32_precision, "ieee"

        def put(value):
            mm.fp32_precision = value
    if prev == full:
        yield
        return
    put(full)
    try:
        yield
    finally:
        put(prev)


@full_f32()
def sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x [..., N, M]``, ``c [..., K, M]`` → ``[..., N, K]``, clamped at 0
    (the expanded form can dip below zero where subtract-then-dot cannot)."""
    xx = (x * x).sum(dim=-1)[..., :, None]
    cc = (c * c).sum(dim=-1)[..., None, :]
    xc = torch.matmul(x, c.transpose(-1, -2))
    return torch.clamp_min(xx + cc - 2.0 * xc, 0.0)


def sqdist_one(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x [..., N, M]``, ``v [..., M]`` → ``[..., N]``."""
    return sqdist(x, v[..., None, :])[..., 0]


#: Rows a product of :func:`assign_chunked` covers.
ASSIGN_CHUNK = 16384


def assign_chunked(x: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = ASSIGN_CHUNK,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid by the clamped :func:`sqdist`, over row chunks:
    ``x [B, N, M]``, ``c [B, K, M]`` → ``(indices [B, N] int32, min_sqdist
    [B, N])``; the argmin keeps the first minimum."""
    b, n, _ = x.shape
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    dmin = torch.empty((b, n), dtype=x.dtype, device=x.device)
    for s in range(0, n, chunk):
        d = sqdist(x[:, s:s + chunk], c)
        dm, di = torch.min(d, dim=-1)
        idx[:, s:s + chunk] = di.to(torch.int32)
        dmin[:, s:s + chunk] = dm
    return idx, dmin
