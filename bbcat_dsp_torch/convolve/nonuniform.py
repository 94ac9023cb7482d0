"""Two-level non-uniform partitioned convolution: the throughput render.

The PyTorch counterpart of the render path of the JAX package's
``convolve/nonuniform.py``.  Level 1 (the head) runs the first ``2 * ratio * block`` taps at
block ``B``; level 2 (the tail) runs the rest at ``B2 = ratio * B``.  The
tail's output is delayed by ``2 * B2`` samples and re-aligned by a 2-slot
``pending`` queue.

The tail queue's ``Pt`` slots hold raw HALF-window spectra: slot ``s``
holds the super-block with ``step % Pt == s``; windows assemble from
consecutive pairs at MAC time.  ``tail.step`` is a host integer, so every
render group knows its queue slot on the host and takes the static-slot
path (K2); the JAX package's traced-slot branch has no counterpart here.

On CUDA tensors the render runs through the six kernels behind
:mod:`bbcat_dsp_torch.ops_hook` (K1 fused head, K5 gather, K3 tail
forward transform, K2 tail MAC, K4 tail inverse transform, K6 delayed
add).  On CPU tensors the same calls run the kernels' plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import ops_hook
from ..ops.kernels.spectral_fir import cplane_mac
from .block import ConvolverState, _roll_slots, convolver_init, partition_ir
from .fft import half_window_signs, spectral_nbins

__all__ = [
    "NonUniformState",
    "NonUniformConvolver",
    "nonuniform_render",
    "nonuniform_render_looped",
]


class NonUniformState(NamedTuple):
    xcarry: torch.Tensor   # [2, P, C, F] last P head window spectra
    prev: torch.Tensor     # [2, C, F] half spectrum of the last small block
    tail: ConvolverState   # xt-slot queue [2, Pt, C, F2], prev, host step
    pending: torch.Tensor  # [2, C, B2] tail outputs awaiting their slot


def _split_ir(ir: np.ndarray, block: int, ratio: int):
    ir = np.atleast_2d(np.asarray(ir))
    n1 = 2 * ratio * block
    return ir[:, :n1], (ir[:, n1:] if ir.shape[1] > n1 else None)


def _head_step(xcarry, prev, H_head, x, block: int):
    """Head over ``x [C, k*block]``: ``(y_head, xcarry', prev')``."""
    return ops_hook.fused_head(x, xcarry, prev, H_head, block)


def _tail_windows_from_xt(tseq: torch.Tensor, s: torch.Tensor):
    """``w[i] = tseq[i] + s * tseq[i+1]``: windows from consecutive half
    spectra ``[2, K+1, C, F]`` -> ``[2, K, C, F]``."""
    return tseq[:, :-1] + s * tseq[:, 1:]


def _tail_step_xt(state: ConvolverState, H, x):
    """One tail super-step over ``x [C, B2]``: ``(state', y [C, B2])``."""
    B2 = x.shape[-1]
    Pt = state.queue.shape[1]
    xt = ops_hook.rfft_half(x, 2 * B2)                     # [2, C, F]
    s = half_window_signs(2 * B2, x.device)
    slot = state.step % Pt
    tseq = torch.cat([_roll_slots(state.queue, slot), xt[:, None]], dim=1)
    w = _tail_windows_from_xt(tseq, s)                     # W(step-Pt+1..step)
    # out = sum_p W(step - p) * H[p]
    acc = cplane_mac(torch.cat([torch.zeros_like(w[:, :1]), w], 1), H, 1)
    y = ops_hook.irfft_tail(acc[:, 0], 2 * B2)
    queue = state.queue.clone()
    queue[:, slot] = xt
    return ConvolverState(queue, xt, state.step + 1), y


def _super_step(state: NonUniformState, H_head, H_tail, x, block: int):
    """One super-block ``x [C, B2]`` -> ``y [C, B2]``."""
    y_head, xcarry, prev = _head_step(state.xcarry, state.prev, H_head, x,
                                      block)
    y = y_head + state.pending[0]
    tail, out_tail = _tail_step_xt(state.tail, H_tail, x)
    pending = torch.stack([state.pending[1], out_tail])
    return NonUniformState(xcarry, prev, tail, pending), y


def _render_group(state: NonUniformState, xg, H_head, H_tail, block: int):
    """One render group of ``Pt`` super-blocks ``xg [C, Pt*B2]``, batched:
    the head over all its small blocks in one K1 launch, the tail's
    transforms over all ``Pt`` super-blocks in one K3 and one K4 launch,
    and the tail MAC over the group's whole window history in one K2
    launch.  Result and final state equal a chain of :func:`_super_step`
    calls."""
    y_head, xcarry, prev = _head_step(state.xcarry, state.prev, H_head, xg,
                                      block)
    Pt = state.tail.queue.shape[1]
    slot0 = state.tail.step % Pt          # the queue cursor, known on host
    B2 = xg.shape[-1] // Pt
    xsup = ops_hook.gather_supers(xg, Pt)                  # [Pt, C, B2]
    xt = ops_hook.rfft_half(xsup, 2 * B2)                  # [2, Pt, C, F2]
    acc = ops_hook.xt_grouped_mac(state.tail.queue, xt, H_tail, slot0)
    out_tail = ops_hook.irfft_tail(acc, 2 * B2)            # [Pt, C, B2]
    # super-step j adds the tail output of super-step j-2
    y = ops_hook.delayed_add(y_head, state.pending, out_tail)
    pending = torch.cat([state.pending, out_tail])[Pt:Pt + 2]
    # the new queue is this group's xt, slot-encoded
    queue = _roll_slots(xt, (Pt - slot0) % Pt)
    tail = ConvolverState(queue, xt[:, -1], state.tail.step + Pt)
    return NonUniformState(xcarry, prev, tail, pending), y


def _render_impl(state: NonUniformState, H_head, H_tail, x, block: int):
    """Render ``x [C, T]``, T a multiple of the super-block.

    When the super-block count is a multiple of ``Pt`` the render runs
    group by group (:func:`_render_group`, one call when there is one
    group); otherwise super-step by super-step."""
    C, T = x.shape
    B2 = state.pending.shape[-1]
    if T % B2:
        raise ValueError(f"T={T} is not a multiple of the super-block {B2}")
    nsuper = T // B2
    Pt = state.tail.queue.shape[1]
    if nsuper % Pt:
        ys = []
        for j in range(nsuper):
            state, y = _super_step(
                state, H_head, H_tail,
                x[:, j * B2:(j + 1) * B2].contiguous(), block)
            ys.append(y)
        return state, torch.cat(ys, dim=-1)
    if nsuper == Pt:
        return _render_group(state, x, H_head, H_tail, block)
    G = Pt * B2
    ys = []
    for g in range(nsuper // Pt):
        state, y = _render_group(state, x[:, g * G:(g + 1) * G].contiguous(),
                                 H_head, H_tail, block)
        ys.append(y)
    return state, torch.cat(ys, dim=-1)


def nonuniform_render(state: NonUniformState, H_head, H_tail, x, block: int):
    """Render ``x [C, T]`` from ``state``: ``(state', y [C, T])``."""
    return _render_impl(state, H_head, H_tail, x, block)


def nonuniform_render_looped(state: NonUniformState, H_head, H_tail, xs,
                             block: int):
    """Render a stack of signals ``xs [R, C, T]`` back to back, state
    chained: ``(state', tails [R, C])``, the last sample of each render.
    The signals must be distinct for a throughput measurement to mean
    streaming work."""
    tails = []
    for x in xs:
        state, y = _render_impl(state, H_head, H_tail, x, block)
        tails.append(y[:, -1])
    return state, torch.stack(tails)


class NonUniformConvolver:
    """Streaming two-level partitioned convolver (render path).

    ``ir [C, N]`` (or ``[N]``, broadcast to ``nchannels``) as a numpy
    array; every tensor lives on ``device``.  :meth:`process` renders
    ``[C, T]`` signals, T a multiple of ``ratio * block``, continuing the
    stream from call to call."""

    def __init__(self, ir, block: int, ratio: int = 8,
                 nchannels: int | None = None, *, device):
        ir2 = np.atleast_2d(np.asarray(ir))
        if nchannels is None:
            nchannels = ir2.shape[0]
        if ir2.shape[0] == 1 and nchannels > 1:
            ir2 = np.broadcast_to(ir2, (nchannels, ir2.shape[1]))
        self.device = torch.device(device)
        self.block = int(block)
        self.ratio = int(ratio)
        self.super_block = self.block * self.ratio
        self.nchannels = nchannels
        head, tail = _split_ir(ir2, self.block, self.ratio)
        self.head_parts = 2 * self.ratio
        self.H_head = partition_ir(head, self.block, self.head_parts,
                                   device=self.device)
        if tail is None:
            tail = np.zeros((nchannels, 1))
        self.tail_parts = max(1, -(-tail.shape[1] // self.super_block))
        self.H_tail = partition_ir(tail, self.super_block, self.tail_parts,
                                   device=self.device)
        self.reset()

    def process(self, x) -> torch.Tensor:
        """Whole-signal render of ``x [C, T]``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.state, y = nonuniform_render(self.state, self.H_head,
                                          self.H_tail, x.contiguous(),
                                          self.block)
        return y

    def reset(self) -> None:
        C, dev = self.nchannels, self.device
        F = spectral_nbins(2 * self.block)
        self.state = NonUniformState(
            xcarry=torch.zeros((2, self.head_parts, C, F), device=dev),
            prev=torch.zeros((2, C, F), device=dev),
            tail=convolver_init(C, self.super_block, self.tail_parts,
                                device=dev),
            pending=torch.zeros((2, C, self.super_block), device=dev),
        )
