"""Uniformly partitioned overlap-save pieces the two-level engine uses.

The counterpart of ``ConvolverState``, ``partition_ir``,
``convolver_init`` and ``_roll_slots`` in the JAX package's
``convolve/block.py``.
The spectral queue is a re/im plane tensor ``[2, P, C, F]``; the step
counter is a host integer, because PyTorch runs eagerly and the slot of
every queue access is then known on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fft import spectral_nbins

__all__ = ["ConvolverState", "partition_ir", "convolver_init"]


class ConvolverState(NamedTuple):
    queue: torch.Tensor  # [2, P, C, F] spectra of past input blocks
    prev: torch.Tensor   # [2, C, F] half-window spectrum of the last block
    step: int            # blocks processed (queue write cursor)


def partition_ir(ir, block: int, nparts: int | None = None, *,
                 device) -> torch.Tensor:
    """Partition an IR ``[C, N]`` (or ``[N]``) into ``block``-tap pieces,
    zero-pad each to ``2 * block`` and transform: ``[2, P, C, F]``
    float32 on ``device``.  The transform runs in float64 on the host."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    C, N = ir.shape
    P = max(1, -(-N // block))
    if nparts is not None:
        if nparts < P:
            raise ValueError(f"IR needs {P} partitions, got nparts={nparts}")
        P = nparts
    padded = np.zeros((C, P * block), np.float64)
    padded[:, :N] = ir
    sp = np.fft.rfft(padded.reshape(C, P, block), n=2 * block, axis=-1)
    sp = np.moveaxis(sp, 1, 0)  # [P, C, F]
    planes = np.ascontiguousarray(np.stack([sp.real, sp.imag]), np.float32)
    return torch.from_numpy(planes).to(device)


def convolver_init(nchannels: int, block: int, nparts: int, *,
                   device) -> ConvolverState:
    F = spectral_nbins(2 * block)
    return ConvolverState(
        queue=torch.zeros((2, nparts, nchannels, F), device=device),
        prev=torch.zeros((2, nchannels, F), device=device),
        step=0,
    )


def _roll_slots(a: torch.Tensor, shift: int, dim: int = 1) -> torch.Tensor:
    """Circular roll: ``out[s] = a[(s + shift) % n]`` along ``dim``."""
    shift %= a.shape[dim]
    return a if shift == 0 else torch.roll(a, -shift, dims=dim)
