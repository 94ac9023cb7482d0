"""Uniformly partitioned overlap-save convolution with click-free IR
exchange: the streaming :class:`BlockConvolver`, and the pieces the
two-level engine shares with it.

The counterpart of the JAX package's ``convolve/block.py``.
The spectral queue is a re/im plane tensor ``[2, P, C, F]``; the step
counter is a host integer, because PyTorch runs eagerly and the slot of
every queue access is then known on the host.  So :func:`convolver_step`
is the reference's static-slot step (``_step_static_slot``), whose MAC is
the rotated MAC (K9, ``ops_hook.rotated_mac``), and :func:`convolver_render`
always takes the reference's static roll for the queue's write-back.  The
render's MAC has the head MAC's contract (K7, ``ops_hook.head_mac``).

The spectral queue may be stored narrower than float32 (``dtype``
bfloat16 or float16, as in the JAX package): a window is rounded to it
when it is written, and every MAC reads it widened to float32 (K9 reads
the narrow queue itself).  Everything else, the carried ``prev``
included, stays float32, so a single render rounds only the queue it
carries out.

The functions (:func:`convolver_render`, :func:`convolver_step`,
:func:`ir_spectra`) are the training surface, as in the JAX package: they
are differentiable in reverse and in forward mode through the kernels
(:mod:`~bbcat_dsp_torch.ops.autograd`), in the IRs, the spectra, the
signal and the state.  :class:`BlockConvolver` keeps its filter and state
out of autograd: it streams, it does not train.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import ops_hook
from ..utils.precision import DTYPES, storage_dtype
from .fft import half_window_signs, spectral_nbins

__all__ = [
    "ConvolverState",
    "partition_ir",
    "ir_spectra",
    "QUEUE_DTYPES",
    "convolver_init",
    "convolver_step",
    "convolver_step_crossfade",
    "convolver_render",
    "BlockConvolver",
]


# the spectral queue's storage types (``utils.precision.DTYPES``)
QUEUE_DTYPES = DTYPES


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


def ir_spectra(ir: torch.Tensor, block: int,
               nparts: int | None = None) -> torch.Tensor:
    """:func:`partition_ir` of an IR tensor ``[C, N]`` (or ``[N]``) on its
    own device, differentiable: the ``[2, P, C, F]`` spectra, so that a
    gradient reaches the time-domain IR.  Each ``block``-tap piece
    zero-padded to ``2 * block`` is exactly the half-window transform's
    input, so the pieces take one K3 launch on the card, in float32 (where
    :func:`partition_ir` transforms in float64 on the host)."""
    ir2 = ir if ir.dim() == 2 else ir[None]
    C, N = ir2.shape
    P = max(1, -(-N // block))
    if nparts is not None:
        if nparts < P:
            raise ValueError(f"IR needs {P} partitions, got nparts={nparts}")
        P = nparts
    padded = torch.nn.functional.pad(ir2, (0, P * block - N))
    parts = padded.reshape(C, P, block).transpose(0, 1).contiguous()
    return ops_hook.rfft_half(parts, 2 * block)


def convolver_init(nchannels: int, block: int, nparts: int,
                   dtype=torch.float32, *, device) -> ConvolverState:
    """The state of silence, queue and ``prev`` of ``dtype`` (one of
    :data:`QUEUE_DTYPES`); after a block ``prev`` is float32."""
    F = spectral_nbins(2 * block)
    dtype = storage_dtype(dtype, "queue")
    return ConvolverState(
        queue=torch.zeros((2, nparts, nchannels, F), dtype=dtype,
                          device=device),
        prev=torch.zeros((2, nchannels, F), dtype=dtype, device=device),
        step=0,
    )


def _roll_slots(a: torch.Tensor, shift: int, dim: int = 1) -> torch.Tensor:
    """Circular roll: ``out[s] = a[(s + shift) % n]`` along ``dim``.  At
    a shift of 0 the result is ``a`` itself, which may be a kernel's
    output saved for a backward pass: no caller writes into it in place
    (``_push`` clones the queue first; the two-level engine copies a queue
    it did not make before its tail steps write into it)."""
    shift %= a.shape[dim]
    return a if shift == 0 else torch.roll(a, -shift, dims=dim)


def _ramp(n: int, device) -> torch.Tensor:
    """The crossfade's ``(k + 1) / n`` over ``n`` samples."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 1) / n


def _push(state: ConvolverState, x: torch.Tensor):
    """Half-window transform of ``x [C, B]``, window assembly by the shift
    theorem, and the queue write at the host slot ``step % P``, rounded
    to the queue's dtype: ``(queue', slot, xt)``, ``xt`` the next state's
    ``prev``.  The write goes to a copy: the old queue may still be
    someone's state."""
    P = state.queue.shape[1]
    B = x.shape[-1]
    xt = ops_hook.rfft_half(x, 2 * B)                     # [2, C, F]
    X = state.prev + half_window_signs(2 * B, x.device) * xt
    slot = state.step % P
    queue = state.queue.clone()
    queue[:, slot] = X
    return queue, slot, xt


def convolver_step(state: ConvolverState, H: torch.Tensor, x: torch.Tensor):
    """One block ``x [C, B]`` -> ``(state', y [C, B])``."""
    B = x.shape[-1]
    queue, slot, xt = _push(state, x)
    y = ops_hook.irfft_tail(ops_hook.rotated_mac(queue, H, slot), 2 * B)
    return ConvolverState(queue, xt, state.step + 1), y


def convolver_step_crossfade(state: ConvolverState, H_old: torch.Tensor,
                             H_new: torch.Tensor, x: torch.Tensor):
    """Filter-exchange block: both filters run on the same queue and the
    outputs fade linearly, ``r[k] = (k + 1) / B`` (the golden crossfade
    contract)."""
    B = x.shape[-1]
    queue, slot, xt = _push(state, x)
    y_old = ops_hook.irfft_tail(ops_hook.rotated_mac(queue, H_old, slot), 2 * B)
    y_new = ops_hook.irfft_tail(ops_hook.rotated_mac(queue, H_new, slot), 2 * B)
    r = _ramp(B, x.device)
    return ConvolverState(queue, xt, state.step + 1), (1 - r) * y_old + r * y_new


def convolver_render(state: ConvolverState, H: torch.Tensor, x: torch.Tensor,
                     block: int):
    """Render ``x [C, T]``, T a multiple of ``block``, as one batched window
    FIR: all ``n = T / block`` blocks in one transform, one MAC (K7) over
    the ``[past P windows | n new]`` history and one inverse.  The final
    state equals a chain of :func:`convolver_step` calls."""
    C, T = x.shape
    B = block
    if T % B or T == 0:
        raise ValueError(f"T={T} is not a positive multiple of the block {B}")
    n = T // B
    P = state.queue.shape[1]
    slot0 = state.step % P
    xb = x.reshape(C, n, B).transpose(0, 1).contiguous()  # [n, C, B]
    xt = ops_hook.rfft_half(xb, 2 * B)                    # [2, n, C, F]
    ext = torch.cat([state.prev[:, None].float(), xt], dim=1)
    X = ext[:, :-1] + half_window_signs(2 * B, x.device) * ext[:, 1:]
    # past P windows, oldest first: the window of step - P + k is in slot
    # (slot0 + k) % P; a narrow queue widens here
    Xext = torch.cat([_roll_slots(state.queue, slot0).float(), X], dim=1)
    acc = ops_hook.head_mac(Xext, H, n)                   # [2, n, C, F]
    y = ops_hook.irfft_tail(acc, 2 * B).transpose(0, 1).reshape(C, T)
    # the last P windows back in slot encoding: window j of them is step
    # step + n - P + j, slot (slot0 + n + j) % P
    queue = _roll_slots(Xext[:, n:n + P], -(slot0 + n)).to(
        state.queue.dtype).contiguous()
    return ConvolverState(queue, xt[:, -1].contiguous(), state.step + n), y


class BlockConvolver:
    """Streaming multi-channel uniformly partitioned convolver with
    host-driven click-free IR exchange.

    ``ir [C, N]`` (or ``[N]``, broadcast to ``nchannels``) as a numpy
    array; every tensor lives on ``device``.  ``dtype`` is the spectral
    queue's storage type (:data:`QUEUE_DTYPES`; float32, or bfloat16 or
    float16 to halve its bytes).  :meth:`process_block` takes one block
    ``[C, block]`` (or ``[block]`` for mono), :meth:`process` a whole
    ``[C, T]`` signal; both continue the same stream."""

    def __init__(self, ir, block: int, nchannels: int | None = None,
                 nparts: int | None = None, dtype=torch.float32, *, device):
        self.dtype = storage_dtype(dtype, "queue")
        ir2 = np.atleast_2d(np.asarray(ir))
        if nchannels is None:
            nchannels = ir2.shape[0]
        if ir2.shape[0] == 1 and nchannels > 1:
            ir2 = np.broadcast_to(ir2, (nchannels, ir2.shape[1]))
        self.device = torch.device(device)
        self.block = int(block)
        self.H = partition_ir(ir2, self.block, nparts, device=self.device)
        self.nparts = self.H.shape[1]
        self.nchannels = nchannels
        self._pending_H = None
        self.reset()

    def set_filter(self, ir, channel: int | None = None) -> None:
        """Schedule a click-free IR exchange at the next block.

        ``channel=None`` replaces all channels' IRs (``ir`` shaped like the
        constructor's); otherwise one channel's.  Per-channel exchanges
        before one block stack."""
        if channel is None:
            ir2 = np.atleast_2d(np.asarray(ir))
            if ir2.shape[0] == 1 and self.nchannels > 1:
                ir2 = np.broadcast_to(ir2, (self.nchannels, ir2.shape[1]))
            newH = partition_ir(ir2, self.block, self.nparts,
                                device=self.device)
        else:
            one = partition_ir(np.asarray(ir), self.block, self.nparts,
                               device=self.device)
            # a copy: the base may be the filter the stream still runs
            newH = (self._pending_H if self._pending_H is not None
                    else self.H).clone()
            newH[:, :, channel] = one[:, :, 0]
        self._pending_H = newH

    def _input(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return (x[None] if x.dim() == 1 else x).contiguous(), x.dim() == 1

    def process_block(self, x) -> torch.Tensor:
        """``x [C, block]`` (or ``[block]``) -> the convolved block."""
        x, mono = self._input(x)
        if x.shape[-1] != self.block:
            raise ValueError(f"block of {x.shape[-1]} samples, expected "
                             f"{self.block}")
        if self._pending_H is not None:
            self.state, y = convolver_step_crossfade(
                self.state, self.H, self._pending_H, x)
            self.H, self._pending_H = self._pending_H, None
        else:
            self.state, y = convolver_step(self.state, self.H, x)
        return y[0] if mono else y

    def process(self, x) -> torch.Tensor:
        """Whole-signal render ``[C, T]`` (or ``[T]``), T a multiple of
        ``block``."""
        x, mono = self._input(x)
        self.state, y = convolver_render(self.state, self.H, x, self.block)
        return y[0] if mono else y

    def reset(self) -> None:
        """Restart the stream from silence, the queue in the engine's
        ``dtype`` (the reference's ``reset`` takes ``prev``'s type, float32
        after a block).  A scheduled exchange stays scheduled, as in the
        reference."""
        self.state = convolver_init(self.nchannels, self.block, self.nparts,
                                    self.dtype, device=self.device)
