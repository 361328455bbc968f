"""Lazy-cumulative weighted sampling.

Reference (``src/distribution.rs``): ``WeightedIndex`` samples an index with
probability proportional to its weight WITHOUT precomputing cumulative sums,
and supports incremental ``update`` of individual weights with atomic
failure (no weight changes if any part of the update is invalid). Zero-weight
entries are never returned (``distribution.rs:99-122``).

In the JAX package this role is played by ``jax.random.categorical`` with
on-device weight updates, in the port by ``torch.multinomial``
(:func:`..ops.kmeans.plusplus_init`); the host-side class is the JAX
package's copy, for parity and for host-side sampling needs. The RNG is
injectable — pass any ``uniform(low, high) -> float`` callable — which is
how the reference makes its distribution tests exactly assertable
(``distribution.rs:124-206``).
"""

from __future__ import annotations

import random
from typing import Callable, List, Sequence

from ..errors import InvalidArgs

Uniform = Callable[[float, float], float]


class WeightedIndex:
    """Samples indices ∝ weight with O(n) lazy cumulative sums."""

    def __init__(self, weights: Sequence[float]) -> None:
        weights = list(weights)
        if not weights:
            raise InvalidArgs("weights is empty")
        if min(weights) < 0:
            raise InvalidArgs("weights contains negative")
        total = sum(weights)
        if total <= 0:
            raise InvalidArgs("total weight is zero")
        self._weights: List[float] = weights
        self._total = total

    def get_weight(self, index: int) -> float:
        return self._weights[index]

    @property
    def total_weight(self) -> float:
        return self._total

    def update(self, new_weights: Sequence[tuple[int, float]]) -> None:
        """Atomic incremental update (``distribution.rs:63-97``): on any
        invalid entry nothing changes."""
        new_total = self._total
        for i, w in new_weights:
            if not 0 <= i < len(self._weights):
                raise InvalidArgs("index out of range")
            if w < 0:
                raise InvalidArgs("new weights contains negative")
            new_total -= self._weights[i]
            new_total += w
        if new_total <= 0:
            raise InvalidArgs("total weight becomes zero")
        for i, w in new_weights:
            self._weights[i] = w
        self._total = new_total

    def sample(self, uniform: Uniform | None = None) -> int:
        """Draws an index; zero-weight entries are never returned
        (``distribution.rs:104-121``)."""
        if uniform is None:
            uniform = random.uniform
        s = uniform(0.0, self._total)
        cum = 0.0
        last_non_zero = None
        for i, w in enumerate(self._weights):
            if w > 0:
                last_non_zero = i
                cum += w
                if cum > s:
                    break
        assert last_non_zero is not None
        return last_non_zero
