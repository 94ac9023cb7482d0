"""Carry IR spectra and streaming state over from the JAX package.

:func:`from_jax_arrays` takes the two-level engine's ``H_head``, ``H_tail``
and ``NonUniformState``, :func:`block_state_from_jax` a ``BlockConvolver``'s
``H`` and ``ConvolverState``, with every leaf already a numpy array (for
example ``jax.tree.map(np.asarray, conv.state)``), and each returns the
port's tensors on ``device``, so a stream started in one package continues
in the other.  A two-level stream crosses at a super-block boundary: the
small-block path's partly filled super-block (``_sb_buf``, ``_sb_fill``) is
not part of the state.  Only the standard spectral layout crosses: a
permuted-layout spectrum (``r * (n/r/2 + 1)`` bins instead of ``n/2 + 1``)
is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convolve.block import ConvolverState
from ..convolve.fft import spectral_nbins
from ..convolve.nonuniform import NonUniformState

__all__ = ["from_jax_arrays", "block_state_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    # a copy: arrays that come from JAX are read-only
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)


def _planes(a, name: str, nbins: int, n: int, device) -> torch.Tensor:
    shape = np.shape(a)
    if shape[0] != 2 or shape[-1] != nbins:
        raise ValueError(
            f"{name}: shape {shape}, expected [2, ..., {nbins}] -- the "
            f"standard layout at FFT size {n} (a permuted-layout state does "
            "not fit the port)")
    return _tensor(a, device)


def from_jax_arrays(H_head, H_tail, state, *, block: int, device):
    """``(H_head, H_tail, NonUniformState)`` as tensors on ``device``.

    ``state`` has the JAX ``NonUniformState``'s fields (``xcarry``,
    ``prev``, ``tail`` with ``queue``/``prev``/``step``, ``pending``) as
    numpy arrays; ``block`` is the head's block size."""
    B2 = np.shape(state.pending)[-1]
    nh, nt = 2 * block, 2 * B2
    Fh, Ft = spectral_nbins(nh), spectral_nbins(nt)
    st = NonUniformState(
        xcarry=_planes(state.xcarry, "xcarry", Fh, nh, device),
        prev=_planes(state.prev, "prev", Fh, nh, device),
        tail=ConvolverState(
            queue=_planes(state.tail.queue, "tail.queue", Ft, nt, device),
            prev=_planes(state.tail.prev, "tail.prev", Ft, nt, device),
            step=int(np.asarray(state.tail.step)),
        ),
        pending=_tensor(state.pending, device),
    )
    return (_planes(H_head, "H_head", Fh, nh, device),
            _planes(H_tail, "H_tail", Ft, nt, device), st)


def block_state_from_jax(H, state, *, block: int, device):
    """``(H, ConvolverState)`` of a ``BlockConvolver`` as tensors on
    ``device``; ``state`` has ``queue``, ``prev`` and ``step`` as numpy
    arrays and ``block`` is the engine's block size."""
    n = 2 * block
    F = spectral_nbins(n)
    st = ConvolverState(
        queue=_planes(state.queue, "queue", F, n, device),
        prev=_planes(state.prev, "prev", F, n, device),
        step=int(np.asarray(state.step)),
    )
    return _planes(H, "H", F, n, device), st
