"""Optimized Product Quantization (OPQ): a learned rotation before PQ (the
JAX package's ``ops/opq.py``).

PQ quantizes each subvector on its own, so dimensions correlated across
division boundaries waste codebook capacity. OPQ learns an orthogonal
rotation ``R`` that lowers ``‖X R − PQ(X R)‖²`` by alternating (a) PQ
training on the rotated data and (b) the orthogonal Procrustes update
``R = U Vᵀ`` from ``SVD(Xᵀ X̂)`` (Ge et al., CVPR 2013). The
reconstruction and the ``[M, M]`` Gram matrix run on the data's device,
every product in full f32 (the JAX package's ``Precision.HIGHEST``); the
small SVD runs on the host in numpy's f32, as in the JAX package.

Distances are preserved (``R`` orthogonal ⇒ ``‖x − q‖ = ‖xR − qR‖``); at
query time the residual is rotated before the ADC tables are built
(:mod:`.adc`, :mod:`.bucketed`).

Randomness: the JAX package folds the iteration number into its key
(``fold_in(key, it)``). Here the inner fit of iteration ``it`` (and the
final fit, ``it = iters``) draws from its own ``torch.Generator`` on the
data's device, seeded with :func:`_fold_in` ``(seed, it)``: two 32-bit
words of numpy's ``SeedSequence([seed, it])``. ``seed`` is the caller's
int, or one draw from the caller's generator. The draws are not the JAX
package's, so fits agree in quality, not in bits.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import kmeans
from .distance import full_f32


class OPQResult(NamedTuple):
    """``rotation [M, M]`` orthogonal; ``pq``: the final PQ fit on the
    rotated, divided data (codes in ``pq.indices [D, N]``)."""
    rotation: torch.Tensor
    pq: kmeans.KMeansResult


def _fold_in(seed: int, it: int, device: torch.device) -> torch.Generator:
    """The generator of iteration ``it``'s inner fit (module docstring)."""
    lo, hi = np.random.SeedSequence([seed, it]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(lo) | int(hi) << 32)


def _reconstruct(pq_centroids: torch.Tensor, pq_indices: torch.Tensor,
                 ) -> torch.Tensor:
    """PQ reconstruction: ``[D, C, m]`` codebooks and ``[D, N]`` codes →
    ``[N, D·m]``."""
    d, n = pq_indices.shape
    parts = pq_centroids[torch.arange(d, device=pq_indices.device)[:, None],
                         pq_indices.long()]                 # [D, N, m]
    return parts.transpose(0, 1).reshape(n, -1)


@full_f32()
def _gram(x: torch.Tensor, yhat: torch.Tensor) -> torch.Tensor:
    """``xᵀ ŷ``, ``[M, M]``, in full f32."""
    return torch.matmul(x.T, yhat)


@full_f32()
def _rotate(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, r)


def _timed(times: Optional[dict], key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with ``times``, its host-clock seconds,
    the device synchronized on both sides, added under ``key``."""
    if times is None:
        return fn(*args, **kwargs)
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else None
    if sync:
        sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        sync()
    times[key] = times.get(key, 0.0) + time.perf_counter() - t0
    return out


def _pq_on_rotated(x: torch.Tensor, r: torch.Tensor,
                   generator: torch.Generator, *, d: int, c: int,
                   rounds: int, impl: Optional[str] = None,
                   times: Optional[dict] = None) -> kmeans.KMeansResult:
    """PQ fit of ``x @ r`` divided into ``d`` subvectors."""
    n, m = x.shape
    y = _timed(times, "rotations", _rotate, x, r)
    divided = y.reshape(n, d, m // d).transpose(0, 1).contiguous()
    del y
    return _timed(times, "pq_fits", kmeans.fit, divided, c, generator,
                  max_rounds=rounds, impl=impl)


def fit_opq(x: torch.Tensor, d: int, c: int,
            generator: torch.Generator | int, *, iters: int = 8,
            inner_rounds: int = 20, final_rounds: int = kmeans.MAX_ROUNDS,
            impl: Optional[str] = None,
            times: Optional[dict] = None) -> OPQResult:
    """Alternating OPQ training on ``x [N, M]`` (typically IVF residuals).

    ``iters`` alternations with ``inner_rounds``-capped Lloyd fits, then a
    full PQ fit at the final rotation. ``generator`` is a
    ``torch.Generator`` or an int seed (module docstring); ``impl`` as in
    :func:`.kmeans.fit` (e.g. ``"_fast"`` numerics). ``times`` (a dict),
    when given, receives the host-clock seconds of the parts, the device
    synchronized around each: ``"pq_fits"``, ``"rotations"`` (``x @ R``),
    ``"reconstructions"``, ``"gram"`` and ``"svd"`` (host, with the Gram's
    copy to the host and the rotation's upload)."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    n, m = x.shape
    if isinstance(generator, torch.Generator):
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
    else:
        seed = int(generator)
    r = torch.eye(m, dtype=torch.float32, device=x.device)
    for it in range(iters):
        pq = _pq_on_rotated(x, r, _fold_in(seed, it, x.device), d=d, c=c,
                            rounds=inner_rounds, impl=impl, times=times)
        yhat = _timed(times, "reconstructions", _reconstruct, pq.centroids,
                      pq.indices)
        g = _timed(times, "gram", _gram, x, yhat)
        del yhat

        def procrustes(g=g):
            u, _, vt = np.linalg.svd(g.cpu().numpy(), full_matrices=False)
            return torch.as_tensor((u @ vt).astype(np.float32),
                                   device=x.device)
        r = _timed(times, "svd", procrustes)
    pq = _pq_on_rotated(x, r, _fold_in(seed, iters, x.device), d=d, c=c,
                        rounds=final_rounds, impl=impl, times=times)
    return OPQResult(r, pq)


def quantization_error(x: torch.Tensor, rotation: torch.Tensor,
                       pq: kmeans.KMeansResult, *, d: int) -> float:
    """Mean squared reconstruction error of ``x`` under ``(rotation,
    pq)``; ``d`` as in the JAX package's signature (the codes' shape
    gives it here)."""
    rotation = torch.as_tensor(rotation, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=rotation.device)
    y = _rotate(x, rotation)
    yhat = _reconstruct(pq.centroids, pq.indices)
    return float(((y - yhat) ** 2).sum(dim=-1).mean())
