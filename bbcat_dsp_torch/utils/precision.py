"""Full float32 products on the card, whatever the caller allows.

The JAX package runs every matrix product of the IIR, loudness, matrix
convolution and mixdown paths, and its 2-D convolution, at
``Precision.HIGHEST``.  PyTorch on a CUDA card runs a float32 matrix
product in TF32 (10 mantissa bits) whenever a caller has set
``torch.backends.cuda.matmul.allow_tf32``, called
``torch.set_float32_matmul_precision("high")`` or set the newer
``fp32_precision`` flags to ``"tf32"``, and runs cuDNN's float32
convolutions in TF32 by default (``torch.backends.cudnn.conv.
fp32_precision`` reads ``"tf32"`` in a fresh process); either caps those
paths far below 90 dB.  :func:`full_f32` is the port's form of
``Precision.HIGHEST``: it sets cuBLAS and cuDNN's convolutions to IEEE
float32 for the work inside it and restores the caller's settings after
it, through the newer flags only (PyTorch refuses to read the older ones
while the two disagree).  On the CPU the settings have no effect.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["full_f32"]


@contextmanager
def full_f32():
    """Run the float32 matrix products and convolutions inside the block
    at full float32."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    prev = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p
