"""Matrix (MIMO, HRTF) partitioned convolution: ``C_in`` inputs, each
convolved with one IR per output and summed into ``C_out`` outputs, with
click-free exchange of the IR matrix.

The counterpart of the JAX package's ``convolve/matrix.py``, in the
standard spectral layout.  It shares :class:`ConvolverState` (the queue
holds the input channels' window spectra), :func:`convolver_init`,
:func:`_push` and the crossfade contract with the uniform
:class:`~bbcat_dsp_torch.convolve.BlockConvolver`.  The half-window
transforms go through ``ops_hook.rfft_half`` (K3) and
``ops_hook.irfft_tail`` (K4).  The filter is held complex and bins first,
``H [F, P, C_in, C_out]``, made once per IR set, and the step and the
render share one mix (:func:`_mix`): per partition one batched complex
product over the bins, at full float32
(:func:`~bbcat_dsp_torch.utils.precision.full_f32`), as the JAX package
runs it at ``Precision.HIGHEST``.

The step counter is a host integer, so the slot of every queue access is
known on the host: the render always takes the reference's static roll,
whether or not its block count is a multiple of P.

The functions (:func:`matrix_render`, :func:`matrix_step`) are the
training surface, differentiable in both modes (K3 and K4 through
:mod:`~bbcat_dsp_torch.ops.autograd`); :class:`MatrixConvolver` keeps its
filter and state out of autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ops_hook
from ..utils.precision import full_f32, storage_dtype
from .block import (
    ConvolverState,
    _push,
    _ramp,
    _roll_slots,
    convolver_init,
)
from .fft import half_window_signs

__all__ = [
    "partition_ir_matrix",
    "filter_from_planes",
    "matrix_step",
    "matrix_step_crossfade",
    "matrix_render",
    "MatrixConvolver",
]


def partition_ir_matrix(ir, block: int, nparts: int | None = None, *,
                        device) -> torch.Tensor:
    """IRs ``[C_in, C_out, N]`` -> spectra ``[F, P, C_in, C_out]``
    complex64 on ``device``; the transform runs in float64 on the host.
    The numbers are those of the JAX package's re/im planes ``[2, P, C_in,
    C_out, F]`` (:func:`filter_from_planes`)."""
    ir = np.asarray(ir, np.float64)
    ci, co, N = ir.shape
    P = max(1, -(-N // block))
    if nparts is not None:
        if nparts < P:
            raise ValueError(f"IR needs {P} partitions, got nparts={nparts}")
        P = nparts
    padded = np.zeros((ci, co, P * block), np.float64)
    padded[..., :N] = ir
    sp = np.fft.rfft(padded.reshape(ci, co, P, block), n=2 * block, axis=-1)
    sp = np.ascontiguousarray(sp.transpose(3, 2, 0, 1), np.complex64)
    return torch.from_numpy(sp).to(device)


def filter_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """Re/im planes ``[2, P, C_in, C_out, F]`` (the JAX package's layout)
    as the port's filter ``[F, P, C_in, C_out]`` complex64."""
    return torch.complex(planes[0], planes[1]).permute(3, 0, 1, 2).contiguous()


def _mix(hist: torch.Tensor, H: torch.Tensor, n: int) -> torch.Tensor:
    """``Y[j] = sum_p W[P - 1 + j - p] H[p]`` for the ``n`` newest windows
    ``j`` of the history ``hist [2, P - 1 + n, C_in, F]`` (re/im planes,
    oldest window first), ``H [F, P, C_in, C_out]``: re/im planes ``[2, n,
    C_out, F]``.  Bins first, each partition's product is one batched
    complex matmul over the bins on a strided view of the history.  A
    narrow queue's history is widened to float32 first."""
    _, P, _, _ = H.shape
    hist = hist.float()
    w = torch.complex(hist[0], hist[1]).permute(2, 0, 1).contiguous()
    with full_f32():
        acc = torch.bmm(w[:, P - 1:P - 1 + n], H[:, 0])
        for p in range(1, P):
            acc.baddbmm_(w[:, P - 1 - p:P - 1 - p + n], H[:, p])
    return torch.view_as_real(acc).permute(3, 1, 2, 0).contiguous()


def _push_hist(state: ConvolverState, x: torch.Tensor):
    """:func:`_push`, and the queue as :func:`_mix`'s history of one new
    window: oldest first, from the slot after the newest."""
    queue, slot, xt = _push(state, x)
    return queue, _roll_slots(queue, slot + 1), xt


def matrix_step(state: ConvolverState, H: torch.Tensor, x: torch.Tensor):
    """One block ``x [C_in, B]`` -> ``(state', y [C_out, B])``."""
    B = x.shape[-1]
    queue, hist, xt = _push_hist(state, x)
    y = ops_hook.irfft_tail(_mix(hist, H, 1)[:, 0], 2 * B)
    return ConvolverState(queue, xt, state.step + 1), y


def matrix_step_crossfade(state: ConvolverState, H_old: torch.Tensor,
                          H_new: torch.Tensor, x: torch.Tensor):
    """Filter-exchange block: both matrices run on the same queue and the
    outputs fade linearly, ``r[k] = (k + 1) / B``."""
    B = x.shape[-1]
    queue, hist, xt = _push_hist(state, x)
    y_old = ops_hook.irfft_tail(_mix(hist, H_old, 1)[:, 0], 2 * B)
    y_new = ops_hook.irfft_tail(_mix(hist, H_new, 1)[:, 0], 2 * B)
    r = _ramp(B, x.device)
    return ConvolverState(queue, xt, state.step + 1), (1 - r) * y_old + r * y_new


def matrix_render(state: ConvolverState, H: torch.Tensor, x: torch.Tensor,
                  block: int):
    """Render ``x [C_in, T]``, T a multiple of ``block``, to ``[C_out, T]``
    as one batched window FIR: all ``n = T / block`` blocks in one
    transform, ``Y[j] = sum_p Xwin[j - p] H[p]`` over the ``[past P
    windows | n new]`` history, one inverse.  The final state equals a
    chain of :func:`matrix_step` calls."""
    Ci, T = x.shape
    B = block
    if T % B or T == 0:
        raise ValueError(f"T={T} is not a positive multiple of the block {B}")
    n = T // B
    P, Co = state.queue.shape[1], H.shape[3]
    slot0 = state.step % P
    xb = x.reshape(Ci, n, B).transpose(0, 1).contiguous()   # [n, Ci, B]
    xt = ops_hook.rfft_half(xb, 2 * B)                       # [2, n, Ci, F]
    ext = torch.cat([state.prev[:, None].float(), xt], dim=1)
    X = ext[:, :-1] + half_window_signs(2 * B, x.device) * ext[:, 1:]
    # past P windows, oldest first: the window of step - P + k is in slot
    # (slot0 + k) % P; a narrow queue widens here
    Xext = torch.cat([_roll_slots(state.queue, slot0).float(), X], dim=1)
    # the oldest of the past windows feeds no output
    y = ops_hook.irfft_tail(_mix(Xext[:, 1:], H, n), 2 * B)
    y = y.transpose(0, 1).reshape(Co, T)
    # the last P windows back in slot encoding: window j of them is step
    # step + n - P + j, slot (slot0 + n + j) % P
    queue = _roll_slots(Xext[:, n:n + P], -(slot0 + n)).to(
        state.queue.dtype).contiguous()
    return ConvolverState(queue, xt[:, -1].contiguous(), state.step + n), y


class MatrixConvolver:
    """Streaming ``C_in -> C_out`` convolver with click-free exchange of the
    IR matrix, on ``device``.

    ``ir_matrix [C_in, C_out, N]`` as a numpy array; ``dtype`` is the
    spectral queue's storage type, as for
    :class:`~bbcat_dsp_torch.convolve.BlockConvolver`.
    :meth:`process_block` takes one block ``[C_in, block]``,
    :meth:`process` a whole ``[C_in, T]`` signal; both continue the same
    stream."""

    def __init__(self, ir_matrix, block: int, nparts: int | None = None,
                 dtype=torch.float32, *, device):
        self.dtype = storage_dtype(dtype, "queue")
        self.device = torch.device(device)
        self.block = int(block)
        self.H = partition_ir_matrix(ir_matrix, self.block, nparts,
                                     device=self.device)
        _, self.nparts, self.c_in, self.c_out = self.H.shape
        self._pending_H = None
        self.reset()

    def set_filter_matrix(self, ir_matrix, in_channel: int | None = None) -> None:
        """Schedule a click-free exchange at the next block: the whole
        matrix, or with ``in_channel`` one input's ``[C_out, N]`` IRs.
        Per-input exchanges before one block stack."""
        if in_channel is None:
            newH = partition_ir_matrix(ir_matrix, self.block, self.nparts,
                                       device=self.device)
        else:
            one = partition_ir_matrix(np.asarray(ir_matrix)[None], self.block,
                                      self.nparts, device=self.device)
            # a copy: the base may be the filter the stream still runs
            newH = (self._pending_H if self._pending_H is not None
                    else self.H).clone()
            newH[:, :, in_channel] = one[:, :, 0]
        self._pending_H = newH

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() != 2 or x.shape[0] != self.c_in:
            raise ValueError(f"input of shape {tuple(x.shape)}, expected "
                             f"[{self.c_in}, T]")
        return x.contiguous()

    def process_block(self, x) -> torch.Tensor:
        """``x [C_in, block]`` -> ``[C_out, block]``."""
        x = self._input(x)
        if x.shape[-1] != self.block:
            raise ValueError(f"block of {x.shape[-1]} samples, expected "
                             f"{self.block}")
        if self._pending_H is not None:
            self.state, y = matrix_step_crossfade(
                self.state, self.H, self._pending_H, x)
            self.H, self._pending_H = self._pending_H, None
        else:
            self.state, y = matrix_step(self.state, self.H, x)
        return y

    def process(self, x) -> torch.Tensor:
        """Whole-signal render ``[C_in, T]`` -> ``[C_out, T]``, T a multiple
        of ``block``.  Like the reference, it renders with the running
        matrix: a scheduled exchange waits for the next block."""
        self.state, y = matrix_render(self.state, self.H, self._input(x),
                                      self.block)
        return y

    def reset(self) -> None:
        """Restart the stream from silence, the queue in the engine's
        ``dtype``.  A scheduled exchange stays scheduled, as in the
        reference."""
        self.state = convolver_init(self.c_in, self.block, self.nparts,
                                    self.dtype, device=self.device)
