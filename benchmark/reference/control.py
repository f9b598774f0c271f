"""The controls: the reference one precision step below each configuration's.

A configuration that serves in bfloat16 has float8 below it: `fp8` rounds
each operand of a product to float8 e4m3 with one scale per tensor (its
largest magnitude to 448, e4m3's largest finite value), the step a later
change to the scan could take. The search serves in float32 with TF32 off,
which has TF32 below it: `tf32` rounds each operand to TF32's 10 mantissa
bits (to nearest, ties to even), as the tensor cores take a float32
product with TF32 on; the product then accumulates in float32. Rounding
the operands here, rather than switching TF32 on, gives the same control
on the CPU, where there is no TF32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().max()
    if amax == 0:
        return x
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), still float32."""
    bits = x.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0x0FFF + odd) & ~0x1FFF).view(torch.float32)
