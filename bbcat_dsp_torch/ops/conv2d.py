"""2-D convolution, the counterpart of the JAX package's ``ops/conv2d.py``.

The JAX package calls XLA's convolution at ``Precision.HIGHEST``; here
``F.conv2d`` (cuDNN on the card) runs inside
:func:`~bbcat_dsp_torch.utils.precision.full_f32`, which keeps cuDNN off
TF32 whatever the caller allowed.  With a kernel of even height or width,
"same" takes scipy's centre, one sample before the JAX package's (which
pads the other side first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.precision import full_f32

__all__ = ["convolve2d"]


def convolve2d(image: torch.Tensor, kernel: torch.Tensor,
               mode: str = "same") -> torch.Tensor:
    """True 2-D convolution (the kernel flipped) of ``image [..., H, W]``
    with ``kernel [kh, kw]``, in float32; ``mode`` "same" (``H x W``),
    "valid" or "full", as ``scipy.signal.convolve2d``."""
    kh, kw = kernel.shape
    if mode == "same":
        # scipy's centre: the full output from row (kh - 1) // 2 on
        pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
    elif mode == "valid":
        pad = (0, 0, 0, 0)
    elif mode == "full":
        pad = (kw - 1, kw - 1, kh - 1, kh - 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = F.pad(image.reshape((-1, 1) + image.shape[-2:]).float(), pad)
    k = torch.flip(kernel, (0, 1)).float()[None, None]
    with full_f32():
        y = F.conv2d(x, k)
    return y.reshape(image.shape[:-2] + y.shape[-2:]).to(image.dtype)
