"""What the drivers share: seeds derived from the run's seed, the data a
configuration states, drawn on the device, the stream of query batches,
and the draw of the answers the check samples."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import synth

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def derive(seed: int, *keys: int) -> int:
    """A seed in ``[0, 2**62)`` for ``keys`` under the run's ``seed``."""
    z = _mix(seed & _MASK)
    for k in keys:
        z = _mix(z ^ (k & _MASK))
    return z >> 2


def sampled(seed: int, i: int, every: int) -> bool:
    """Whether call ``i`` is in the check's sample: one call in ``every``
    on average, drawn from the seed, whatever the window's length."""
    return derive(seed, 0x5A3, i) % every == 0


def check_rows(n: int, seed: int, rows: int, device) -> torch.Tensor:
    """The corpus rows a build's check samples: ``rows`` of ``n``, drawn
    from the run's ``seed``."""
    gen = torch.Generator(device).manual_seed(derive(seed, 0x5A3))
    return torch.randperm(n, generator=gen, device=device)[:rows]


def make_data(cfg: dict, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The corpus ``[rows, dim]`` and the query pool ``[query_pool, dim]``
    the configuration states, f32 on ``device``, from its ``data_seed``:
    the deployment's data, the same for every run's seed (a corpus drawn
    from the run's seed moves the largest partition, and with it the
    buckets' length and a query's work, by a tenth)."""
    gen = torch.Generator(device).manual_seed(
        derive(cfg["data_seed"], 0xDA7A))
    data = cfg["data"]
    return synth.gmm_pair(gen, cfg["rows"], cfg["query_pool"], cfg["dim"],
                          n_clusters=data["components"],
                          intrinsic=data["intrinsic"],
                          cluster_std=data["cluster_std"],
                          noise=data["noise"])


class QueryStream:
    """Batches of ``batch`` queries from the pool: the pool's rows in the
    order of successive permutations drawn from ``seed``, cut in batches,
    so every seed sends the same sizes and a batch never repeats a row."""

    def __init__(self, pool: np.ndarray, batch: int, seed: int) -> None:
        if batch > len(pool):
            raise ValueError(f"batch {batch} exceeds the pool {len(pool)}")
        self.pool, self.batch, self.seed = pool, batch, seed
        self._perms = {}

    def _perm(self, j: int) -> np.ndarray:
        if j not in self._perms:
            if len(self._perms) > 4:
                self._perms.clear()
            self._perms[j] = np.random.default_rng(
                [self.seed, j]).permutation(len(self.pool))
        return self._perms[j]

    def indices(self, i: int) -> np.ndarray:
        n = len(self.pool)
        a, b = i * self.batch, (i + 1) * self.batch
        ja, jb = a // n, (b - 1) // n
        if ja == jb:
            return self._perm(ja)[a - ja * n:b - ja * n]
        return np.concatenate([self._perm(ja)[a - ja * n:],
                               self._perm(jb)[:b - jb * n]])

    def queries(self, i: int) -> np.ndarray:
        return self.pool[self.indices(i)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What a driver gets: the cell, the run's seed and device, whether
    the run is traced, and a clock for the set-up's parts."""
    cell: object
    seed: int
    device: str
    trace: bool = False
    parts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def part(self, name: str):
        """Times a part of the set-up, the device synchronized at its end."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.parts[name] = self.parts.get(name, 0.0) + \
            time.perf_counter() - t0
