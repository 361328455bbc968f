"""The benchmark's data generator: a frozen copy of
``flechasdb_tpu_torch/synth.py``'s ``gmm_pair_device`` (with
``_gmm_params_device`` and ``_gmm_sample_device``), so that a change to
the program cannot change the data the benchmark measures it on.

A Gaussian mixture on a shared low-rank manifold: ``n_clusters``
components with ``1/i^0.7`` weights, means drawn in an
``intrinsic``-dimensional latent space and pushed through one random
linear map, anisotropic per-component noise at ``cluster_std`` and a
small full-dimensional noise floor. Everything is drawn on the
generator's device, ``chunk`` rows at a time, never on the host.
"""

from __future__ import annotations

import torch


def _full_f32():
    """Full-f32 matmuls within (the copy's own, so it imports nothing of
    the program)."""
    return _Precision("highest")


class _Precision:
    def __init__(self, value: str) -> None:
        self.value = value

    def __enter__(self):
        self.prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.value)

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.prev)


def _params(generator: torch.Generator, m: int, n_clusters: int,
            intrinsic: int, cluster_std: float):
    dev = generator.device
    w = torch.randn((intrinsic, m), generator=generator, device=dev)
    means_z = torch.randn((n_clusters, intrinsic), generator=generator,
                          device=dev)
    with _full_f32():
        means = (means_z * 2.0) @ w
    weights = 1.0 / torch.arange(1, n_clusters + 1, dtype=torch.float64,
                                 device=dev) ** 0.7
    cdf = torch.cumsum(weights / weights.sum(), 0)
    scales = cluster_std * (0.5 + torch.rand(
        (n_clusters, intrinsic), generator=generator, device=dev))
    return w, means, cdf, scales


def _sample(generator: torch.Generator, params, n: int, m: int,
            noise: float, chunk: int) -> torch.Tensor:
    w, means, cdf, scales = params
    dev = generator.device
    intrinsic = w.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with _full_f32():
        for lo in range(0, n, chunk):
            rows = min(chunk, n - lo)
            u = torch.rand(rows, generator=generator, device=dev,
                           dtype=torch.float64)
            comp = torch.searchsorted(cdf, u).clamp_max_(len(cdf) - 1)
            z = torch.randn((rows, intrinsic), generator=generator,
                            device=dev)
            out[lo:lo + rows] = (means[comp] + (z * scales[comp]) @ w
                                 + noise * torch.randn((rows, m),
                                                       generator=generator,
                                                       device=dev))
    return out


def gmm_pair(generator: torch.Generator, n: int, nq: int, m: int, *,
             n_clusters: int = 256, intrinsic: int = 12,
             cluster_std: float = 0.35, noise: float = 0.05,
             chunk: int = 1 << 19) -> tuple[torch.Tensor, torch.Tensor]:
    """A corpus ``[n, m]`` and ``nq`` queries, f32 on ``generator``'s
    device, drawn from the same mixture (one set of parameters, two
    samples)."""
    params = _params(generator, m, n_clusters, intrinsic, cluster_std)
    return (_sample(generator, params, n, m, noise, chunk),
            _sample(generator, params, nq, m, noise, chunk))
