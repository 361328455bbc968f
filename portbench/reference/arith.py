"""The arithmetic the reference runs in.

:data:`F64` is the judge's: every product and sum in float64. :data:`TF32`
is the control's, the nearest precision below the f32 the configurations
state: float32 tensors whose matrix products take operands rounded to
TF32 (10 mantissa bits, round to nearest, ties away from zero, as the
tensor cores' ``cvt.rna.tf32.f32`` does) and accumulate in f32. The
rounding is done here, so a CPU run computes the same control as the card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to the nearest TF32 value, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _exact_f32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclass(frozen=True)
class Arith:
    name: str
    dtype: torch.dtype

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched like ``torch.matmul``) in this arithmetic."""
        if self.name == "f64":
            return torch.matmul(a.double(), b.double())
        with _exact_f32():
            return torch.matmul(tf32_round(a.float()), tf32_round(b.float()))


F64 = Arith("f64", torch.float64)
TF32 = Arith("tf32", torch.float32)
