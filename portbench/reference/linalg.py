"""How the reference computes: a floating type and a matrix product.

``F64`` is the reference.  ``TF32`` is the control: float32 arithmetic
whose products take their operands rounded to TF32 (10 mantissa bits,
round to nearest even) and accumulate in float32, as the tensor cores do
with TF32 on.  The rounding is explicit, so the control computes alike on
any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b


F64 = Precision("float64", torch.float64)
TF32 = Precision("tf32", torch.float32, tf32=True)
