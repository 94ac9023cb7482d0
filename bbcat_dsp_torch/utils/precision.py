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

:func:`storage_dtype` is the one check of every ``dtype`` argument in the
port: float32, bfloat16 or float16 (:data:`DTYPES`), as the JAX package
takes them, and float64 only where an engine computes in it.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["DTYPES", "NARROW", "full_f32", "host_tensor", "promoted",
           "storage_dtype", "sum_in_order"]

# the storage types a ``dtype`` argument takes; the JAX package with
# 64-bit types off quietly makes float32 of a float64 request, the port
# refuses it where it does not compute in float64
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
NARROW = (torch.bfloat16, torch.float16)


def storage_dtype(dtype, what: str, float64: bool = False) -> torch.dtype:
    """``dtype`` if it is one of :data:`DTYPES` (or float64, where
    ``float64`` says the caller computes in it), else ``ValueError``
    naming the accepted set; ``what`` names the argument's use."""
    accepted = DTYPES + ((torch.float64,) if float64 else ())
    if dtype not in accepted:
        raise ValueError(f"{what} dtype {dtype}: takes one of {accepted}")
    return dtype


def host_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values (float64, as designed) as a ``dtype`` tensor on
    ``device``, rounded as the JAX package rounds them: float16 once from
    float64 (numpy's cast), bfloat16 through float32 (``ml_dtypes``' and
    PyTorch's cast alike)."""
    a = np.asarray(a, np.float64)
    if dtype == torch.float64:
        return torch.from_numpy(a).to(device)
    host = a.astype(np.float16 if dtype == torch.float16 else np.float32)
    return torch.from_numpy(host).to(device).to(dtype)


def promoted(*dtypes: torch.dtype) -> torch.dtype:
    """The type the JAX package computes mixed operands in: their own if
    they agree, else float64 if one is, else float32 (bfloat16 with
    float16 included).  The port casts to it explicitly."""
    if all(d == dtypes[0] for d in dtypes):
        return dtypes[0]
    return torch.float64 if torch.float64 in dtypes else torch.float32


def sum_in_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The JAX package's ``jnp.sum`` of a narrow operand along ``dim``, as
    it runs operation by operation: the terms widened to float32 and added
    one after the other in index order (XLA:CPU's order at the port's
    lengths, up to 16 terms).  The caller rounds the float32 sum once.
    ``torch.sum`` keeps several partial sums along a short last axis, so
    its float32 result, and now and then the rounded one, differs."""
    terms = t.float().movedim(dim, 0)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


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
