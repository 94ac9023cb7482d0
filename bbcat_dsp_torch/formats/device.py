"""Sample conversions on the device: MSB-aligned int32 <-> float32.

The counterpart of ``float_to_int32`` and ``int32_to_float`` in the JAX
package's ``formats/device.py``, with the same arithmetic: scaling by a
power of two is exact, the clamp runs in float32 and the cast truncates,
so both packages give the same bits on the same input.
"""

from __future__ import annotations

import torch

__all__ = ["float_to_int32", "int32_to_float"]

_SCALE_UP = 2147483648.0  # 2^31
_SCALE_DOWN = 2.0 ** -31
# the largest float32 below 2^31: clamping to it keeps the cast in int32
_MAX_F32_INT = 2147483520.0


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> MSB-aligned int32: scale by 2^31, saturate, truncate."""
    d = torch.clamp(x.float() * _SCALE_UP, -_SCALE_UP, _MAX_F32_INT)
    return torch.trunc(d).to(torch.int32)


def int32_to_float(x: torch.Tensor) -> torch.Tensor:
    """MSB-aligned int32 -> float32: scale by 2^-31."""
    return x.float() * _SCALE_DOWN
