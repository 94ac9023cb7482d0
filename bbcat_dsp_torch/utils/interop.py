"""Carry IR spectra and streaming state over from the JAX package.

:func:`from_jax_arrays` takes the two-level engine's ``H_head``, ``H_tail``
and ``NonUniformState``, :func:`block_state_from_jax` a ``BlockConvolver``'s
``H`` and ``ConvolverState`` (:func:`matrix_state_from_jax` a
``MatrixConvolver``'s), with every leaf already a numpy array (for
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
from ..convolve.matrix import filter_from_planes
from ..convolve.nonuniform import NonUniformState
from ..filters.iir import ModalParams, ModalState
from ..loudness.itu1770 import MeterState
from ..models.binaural import BinauralState

__all__ = ["from_jax_arrays", "block_state_from_jax", "matrix_state_from_jax",
           "modal_from_jax", "meter_state_from_jax", "binaural_state_from_jax",
           "to_numpy"]


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
    """``(H, ConvolverState)`` of a ``BlockConvolver`` (``H [2, P, C, F]``)
    as tensors on ``device``; ``state`` has ``queue``, ``prev`` and
    ``step`` as numpy arrays and ``block`` is the engine's block size."""
    n = 2 * block
    F = spectral_nbins(n)
    st = ConvolverState(
        queue=_planes(state.queue, "queue", F, n, device),
        prev=_planes(state.prev, "prev", F, n, device),
        step=int(np.asarray(state.step)),
    )
    return _planes(H, "H", F, n, device), st


def matrix_state_from_jax(H, state, *, block: int, device):
    """As :func:`block_state_from_jax` for a ``MatrixConvolver``: ``H [2,
    P, C_in, C_out, F]`` comes back as the port's complex ``[F, P, C_in,
    C_out]``."""
    H, st = block_state_from_jax(H, state, block=block, device=device)
    return filter_from_planes(H), st


def modal_from_jax(leaves, *, device):
    """A ``ModalParams`` (fields ``b0`` .. ``p2i``) or ``ModalState``
    (``x1`` .. ``wi``) of numpy arrays as the port's tuple on ``device``."""
    cls = ModalParams if hasattr(leaves, "b0") else ModalState
    return cls(*(_tensor(getattr(leaves, f), device) for f in cls._fields))


def meter_state_from_jax(state, *, device) -> MeterState:
    """A ``LoudnessMeter``'s ``MeterState`` of numpy arrays as the port's
    on ``device``; assign it to the port meter's ``state``."""

    def counts(a):
        return torch.from_numpy(np.array(a, np.int32)).to(device)

    return MeterState(
        shelf=modal_from_jax(state.shelf, device=device),
        rlb=modal_from_jax(state.rlb, device=device),
        sq_tail=_tensor(state.sq_tail, device),
        hist_count=counts(state.hist_count),
        hist_sum=_tensor(state.hist_sum, device),
        momentary_z=_tensor(state.momentary_z, device),
        short_ring=_tensor(state.short_ring, device),
        st_count=counts(state.st_count),
        st_sum=_tensor(state.st_sum, device),
        nblocks=int(np.asarray(state.nblocks)),
    )


def binaural_state_from_jax(H, state, *, block: int, device):
    """``(H, BinauralState)`` of a ``BinauralRenderer`` as tensors on
    ``device``: ``state`` has ``eq`` (one ``ModalState`` per stage) and
    ``conv`` (a ``ConvolverState``) with numpy leaves."""
    H, conv = matrix_state_from_jax(H, state.conv, block=block, device=device)
    eq = tuple(modal_from_jax(s, device=device) for s in state.eq)
    return H, BinauralState(eq=eq, conv=conv)


def to_numpy(tree):
    """The port's state with every tensor as a numpy array, tuples and
    named tuples rebuilt around them; integers stay integers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple):
        leaves = [to_numpy(t) for t in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree
