"""Dense linear-algebra primitives (the JAX package's ``ops/linalg.py``).

The reference hand-unrolls these for CPU SIMD (``src/linalg.rs``); here,
as in the JAX package, each is one tensor expression, and the module pins
down the edge cases the reference's unit tests encode: empty inputs, the
overflow-safe ``norm2`` prescaling (``linalg.rs:61-75``), min and max on
empty slices. Every function takes numpy arrays or tensors and returns a
tensor, reducing over the last axis.
"""

from __future__ import annotations

import torch


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a)


def dot(a, b) -> torch.Tensor:
    """Inner product (``linalg.rs:12-40``). Empty inputs yield 0."""
    return (_t(a) * _t(b)).sum(dim=-1)


def norm2(v) -> torch.Tensor:
    """Euclidean norm with overflow-safe prescaling (``linalg.rs:61-75``):
    divided by ``max_abs`` before squaring, so entries near ``1e36`` (f32)
    do not overflow to inf; a zero vector yields 0."""
    v = _t(v)
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype)
    s = v.abs().amax(dim=-1, keepdim=True)
    scaled = v / torch.where(s > 0, s, torch.ones_like(s))
    return s.squeeze(-1) * torch.sqrt((scaled * scaled).sum(dim=-1))


def subtract(a, b) -> torch.Tensor:
    """Elementwise ``a - b`` (``linalg.rs:166-184``)."""
    return _t(a) - _t(b)


def add(a, b) -> torch.Tensor:
    """Elementwise ``a + b`` (``linalg.rs:149-163``)."""
    return _t(a) + _t(b)


def scale(v, s) -> torch.Tensor:
    """Elementwise ``v * s`` (``linalg.rs:187-203``)."""
    return _t(v) * s


def sum_(v) -> torch.Tensor:
    """Sum of all elements (``linalg.rs:208-230``). Empty ⇒ 0."""
    return _t(v).sum(dim=-1)


def min_(v) -> torch.Tensor:
    """Minimum element (``linalg.rs:233-289``). Empty ⇒ +inf."""
    v = _t(v)
    if v.shape[-1] == 0:
        return torch.full(v.shape[:-1], float("inf"), dtype=v.dtype)
    return v.amin(dim=-1)


def max_abs(v) -> torch.Tensor:
    """Maximum absolute element (``linalg.rs:292-345``). Empty ⇒ 0."""
    v = _t(v)
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype)
    return v.abs().amax(dim=-1)
