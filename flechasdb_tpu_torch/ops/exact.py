"""Exact (flat) k-NN scan (the JAX package's ``ops/exact.py``).

A brute-force scan as a running top-k fold over corpus chunks: one
``[B, chunk]`` distance product per step, so a corpus of any size streams
through device memory with a bounded footprint. The JAX package runs it in
XLA outside any Pallas kernel; here every step is a cuBLAS product in full
f32 (:func:`.distance.full_f32`, as the JAX code pins ``HIGHEST``) and the
fold keeps the lower index among equal keys, as ``jax.lax.top_k`` over
``[best, new]`` does (:func:`.adc.smallest_k`, whose order is a stable
sort's). Tensors stay on their own device. Each :func:`exact_topk` call
counts its queries (``exact.queries``) and the (query, row) pairs it
scores (``exact.pairs``) while a profiler collects.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import count
from .adc import smallest_k
from .distance import full_f32, sqdist


def exact_keys(q: torch.Tensor, x: torch.Tensor,
               metric: str = "l2") -> torch.Tensor:
    """Exact ranking keys ``[B, N]``: the clamped squared L2 distance, or
    ``−⟨q, x⟩`` for ``"dot"`` (cosine callers pass unit vectors with the
    L2 key)."""
    if metric == "dot":
        with full_f32():
            return -torch.matmul(q, x.T)
    return sqdist(q, x)


def exact_topk(q: torch.Tensor, x: torch.Tensor,
               row_mask: Optional[torch.Tensor] = None, *, k: int,
               chunk: int = 1 << 17,
               metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours of each query.

    ``q: [B, M]``, ``x: [N, M]`` → ``(sq_distances [B, k], rows [B, k]
    int32)``, ascending. Entries beyond ``N`` carry ``+inf`` and row 0.
    ``row_mask [N] bool`` (optional) excludes rows whose mask is False
    (attribute filtering, :mod:`..filters`). ``metric``: ``"dot"`` ranks
    by ``−⟨q, x⟩`` (maximum inner product); anything else by the L2 key.
    """
    b = q.shape[0]
    n = x.shape[0]
    count("exact.queries", b)
    count("exact.pairs", b * n)
    inf = float("inf")
    best_d = torch.full((b, k), inf, dtype=torch.float32, device=q.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=q.device)
    if n == 0:
        return best_d, best_i
    chunk = min(chunk, n)
    steps = -(-n // chunk)
    span = torch.arange(chunk, dtype=torch.int32, device=q.device)
    for i in range(steps):
        start = min(i * chunk, n - chunk)
        d = exact_keys(q, x[start:start + chunk], metric)      # [B, chunk]
        rows = span + start
        # Overlapping rows in the (shifted) last chunk must not appear
        # twice in the running set: mask rows already covered.
        fresh = rows >= i * chunk
        if row_mask is not None:
            fresh &= row_mask[start:start + chunk]
        d = d.masked_fill_(~fresh[None, :], inf)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, rows[None, :].expand(b, chunk)], dim=1)
        del d
        best_d, sel = smallest_k(cat_d, k)
        best_i = cat_i.gather(1, sel)
        del cat_d, cat_i, sel
    return best_d, best_i
