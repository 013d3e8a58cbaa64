"""Float-to-integer casts with XLA's semantics.

The JAX package casts with ``astype``, which XLA defines for every
input: NaN becomes 0 and values outside the target range saturate at its
ends, then the value truncates toward zero. PyTorch's ``Tensor.to``
leaves NaN, infinities and out-of-range values undefined (on the CPU an
f32 NaN, inf or 3e9 cast to int32 gives -2**31, and 256.0 cast to uint8
wraps to 0). Every cast whose input can leave the range goes through
these helpers, so the port writes what the JAX package writes.
"""

from __future__ import annotations

import torch

_I32_MIN = -2 ** 31
_I32_MAX = 2 ** 31 - 1
_F32_BELOW_2_31 = 2147483520.0     # 2**31 - 128


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 of float ``x`` as XLA casts it: NaN -> 0, saturate at the
    int32 range, truncate toward zero.

    2**31 - 1 rounds up to 2**31 in float32, so a clamp to it would
    still overflow the cast: the clamp stops at the largest float32
    below 2**31 and a select writes 2**31 - 1 above it.
    """
    out = torch.nan_to_num(x, nan=0.0).clamp(
        float(_I32_MIN), _F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, _I32_MAX, out)


def f32_to_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 of float ``x`` as XLA casts it: NaN -> 0, saturate to
    [0, 255], truncate toward zero."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, 255.0).to(torch.uint8)
