"""Full float32 matrix products on the card, whatever the caller allows.

The JAX package runs every matrix product of the IIR, loudness, matrix
convolution and mixdown paths at ``Precision.HIGHEST``.  PyTorch on a CUDA
card runs a float32 product in TF32 (10 mantissa bits) whenever a caller
has set ``torch.backends.cuda.matmul.allow_tf32``, called
``torch.set_float32_matmul_precision("high")`` or set the newer
``fp32_precision`` flags to ``"tf32"``; that caps those paths far below
90 dB.  :func:`full_f32` is the port's form of ``Precision.HIGHEST``: it
sets cuBLAS to IEEE float32 for the products inside it and restores the
caller's setting after them.  On the CPU the setting has no effect.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["full_f32"]


@contextmanager
def full_f32():
    """Run the float32 matrix products inside the block at full float32."""
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    flags.fp32_precision = "ieee"
    try:
        yield
    finally:
        flags.fp32_precision = prev
