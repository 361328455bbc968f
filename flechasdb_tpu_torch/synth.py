"""Synthetic descriptor-like corpora (the JAX package's
``utils/synth.gmm_corpus`` and ``gmm_pair``, numpy only).

A Gaussian mixture on a shared low-rank manifold: ``n_clusters``
components with Zipf-ish weights, means drawn in an ``intrinsic``-dim
latent space and pushed through one random linear map, anisotropic
per-component noise at ``cluster_std`` and a small full-dimensional noise
floor. At ``m=128, intrinsic=12, n_clusters=256`` it is the JAX package's
SIFT1M-shaped stand-in. A copy, for the reason given in :mod:`.errors`;
for the same ``numpy.random.Generator`` state it draws the same arrays as
the original, bit for bit.
"""

from __future__ import annotations

import numpy as np


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
