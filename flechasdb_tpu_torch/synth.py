"""Synthetic descriptor-like corpora (the JAX package's
``utils/synth.py``): ``gmm_corpus`` and ``gmm_pair`` in numpy, and
``gmm_corpus_device`` and ``gmm_pair_device``, which draw on a device.

A Gaussian mixture on a shared low-rank manifold: ``n_clusters``
components with Zipf-ish weights, means drawn in an ``intrinsic``-dim
latent space and pushed through one random linear map, anisotropic
per-component noise at ``cluster_std`` and a small full-dimensional noise
floor. At ``m=128, intrinsic=12, n_clusters=256`` it is the JAX package's
SIFT1M-shaped stand-in. A copy, for the reason given in :mod:`.errors`;
for the same ``numpy.random.Generator`` state it draws the same arrays as
the original, bit for bit. The device sampler draws the same mixture
family from a ``torch.Generator`` instead of a JAX key: statistically
equivalent to the JAX package's, not bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.distance import full_f32


def gmm_corpus(rng: np.random.Generator, n: int, m: int, *,
               n_clusters: int = 256, intrinsic: int = 12,
               cluster_std: float = 0.35, noise: float = 0.05,
               chunk: int = 1 << 18) -> np.ndarray:
    """Clustered descriptor-like corpus ``[n, m]`` float32."""
    w = rng.standard_normal((intrinsic, m)).astype(np.float32)
    means_z = rng.standard_normal((n_clusters, intrinsic)).astype(np.float32)
    means = (means_z * 2.0) @ w                        # spread clusters out
    weights = 1.0 / np.arange(1, n_clusters + 1) ** 0.7
    weights /= weights.sum()
    scales = (cluster_std *
              rng.uniform(0.5, 1.5, (n_clusters, intrinsic))
              ).astype(np.float32)

    out = np.empty((n, m), np.float32)
    for i in range(0, n, chunk):
        nn = min(chunk, n - i)
        comp = rng.choice(n_clusters, size=nn, p=weights)
        z = rng.standard_normal((nn, intrinsic)).astype(np.float32)
        out[i:i + nn] = (means[comp] + (z * scales[comp]) @ w +
                         noise * rng.standard_normal((nn, m)
                                                     ).astype(np.float32))
    return out


def gmm_pair(rng: np.random.Generator, n: int, nq: int, m: int, **kw
             ) -> tuple[np.ndarray, np.ndarray]:
    """Corpus and held-out queries drawn from the SAME mixture."""
    both = gmm_corpus(rng, n + nq, m, **kw)
    perm = rng.permutation(n + nq)
    return both[perm[:n]], both[perm[n:]]


def _gmm_params_device(generator: torch.Generator, m: int, n_clusters: int,
                       intrinsic: int, cluster_std: float):
    """The mixture on the generator's device: the latent map ``w``, the
    component means, the cumulative ``1/i^0.7`` weights and the latent
    scales, uniform in [0.5, 1.5) times ``cluster_std``."""
    dev = generator.device
    w = torch.randn((intrinsic, m), generator=generator, device=dev)
    means_z = torch.randn((n_clusters, intrinsic), generator=generator,
                          device=dev)
    with full_f32():
        means = (means_z * 2.0) @ w
    weights = 1.0 / torch.arange(1, n_clusters + 1, dtype=torch.float64,
                                 device=dev) ** 0.7
    cdf = torch.cumsum(weights / weights.sum(), 0)
    scales = cluster_std * (0.5 + torch.rand(
        (n_clusters, intrinsic), generator=generator, device=dev))
    return w, means, cdf, scales


@full_f32()
def _gmm_sample_device(generator: torch.Generator, params, n: int, m: int,
                       noise: float, chunk: int) -> torch.Tensor:
    """``n`` rows of the mixture, drawn ``chunk`` rows at a time into the
    output: the peak is the output plus O(chunk·m)."""
    w, means, cdf, scales = params
    dev = generator.device
    intrinsic = w.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        rows = min(chunk, n - lo)
        u = torch.rand(rows, generator=generator, device=dev,
                       dtype=torch.float64)
        comp = torch.searchsorted(cdf, u).clamp_max_(len(cdf) - 1)
        z = torch.randn((rows, intrinsic), generator=generator, device=dev)
        out[lo:lo + rows] = (means[comp] + (z * scales[comp]) @ w
                             + noise * torch.randn((rows, m),
                                                   generator=generator,
                                                   device=dev))
    return out


def gmm_corpus_device(generator: torch.Generator, n: int, m: int, *,
                      n_clusters: int = 256, intrinsic: int = 12,
                      cluster_std: float = 0.35, noise: float = 0.05,
                      chunk: int = 1 << 19) -> torch.Tensor:
    """:func:`gmm_corpus` drawn on ``generator``'s device: ``[n, m]`` f32
    there, made in ``chunk``-row pieces, never on the host."""
    params = _gmm_params_device(generator, m, n_clusters, intrinsic,
                                cluster_std)
    return _gmm_sample_device(generator, params, n, m, noise, chunk)


def gmm_pair_device(generator: torch.Generator, n: int, nq: int, m: int, *,
                    n_clusters: int = 256, intrinsic: int = 12,
                    cluster_std: float = 0.35, noise: float = 0.05,
                    chunk: int = 1 << 19,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A corpus ``[n, m]`` and ``nq`` queries drawn on the device from the
    SAME mixture (one set of parameters, two samples), in the place of
    :func:`gmm_pair`'s held-out split."""
    params = _gmm_params_device(generator, m, n_clusters, intrinsic,
                                cluster_std)
    return (_gmm_sample_device(generator, params, n, m, noise, chunk),
            _gmm_sample_device(generator, params, nq, m, noise, chunk))
