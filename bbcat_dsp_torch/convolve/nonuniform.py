"""Two-level non-uniform partitioned convolution: render and streaming.

The PyTorch counterpart of the JAX package's ``convolve/nonuniform.py``.
Level 1 (the head) runs the first ``2 * ratio * block`` taps at block
``B``; level 2 (the tail) runs the rest at ``B2 = ratio * B``.  The
tail's output is delayed by ``2 * B2`` samples and re-aligned by a 2-slot
``pending`` queue.

The tail queue's ``Pt`` slots hold raw HALF-window spectra: slot ``s``
holds the super-block with ``step % Pt == s``; windows assemble from
consecutive pairs at MAC time.  ``tail.step`` is a host integer, so every
render group knows its queue slot on the host and takes the static-slot
path (K2); the JAX package's traced-slot branch has no counterpart here.

On CUDA tensors the render runs through six kernels behind
:mod:`bbcat_dsp_torch.ops_hook` (K1 fused head, K5 gather, K3 tail
forward transform, K2 tail MAC, K4 tail inverse transform, K6 delayed
add).  The streaming paths (:meth:`NonUniformConvolver.process_block`,
:meth:`~NonUniformConvolver.process_small_block`) and the click-free IR
exchange (:meth:`~NonUniformConvolver.set_filter`) add the head MAC (K7)
and the single-step tail MAC (K2s): the head of a crossfade or of one
small block is K3, K7, K4, and every per-super-step tail is K3, K2s, K4
(K2s twice when the tail fades).  On CPU tensors the same calls run the
kernels' plain versions.

The engine owns its tail queue: a streaming tail step retires the
queue's oldest slot in place, inside K2s's launch.  A queue the engine
does not hold alone (a render group's, which ``tail.prev`` may view; one
read from or assigned to the engine's ``state``) is copied once, at the
next such step.  The functions, and any step that records a derivative,
leave the state they are given as it was and return a new queue.

Under ``torch.profiler`` the layers are spans
(:func:`~bbcat_dsp_torch.utils.profiling.span`): ``nonuniform.process``,
``nonuniform.small_block``, ``nonuniform.input``, ``nonuniform.head_step``
and ``nonuniform.tail_step``; on a card the first and the last also take
their device extent.

``dtype`` bfloat16 or float16 stores the tail queue narrow, as the JAX
package's engine does once a block has run: a super-step reads it widened
to float32 and rounds only the half spectrum it writes; everything else
is float32 and the kernels see float32 operands.  Only
:meth:`NonUniformConvolver.process_block` (with :meth:`~NonUniformConvolver.
set_filter`) runs narrow, as in the reference, whose narrow ``process``
and ``process_small_block`` fail with a ``TypeError``: here they raise a
``ValueError`` that says so.

The functions (:func:`nonuniform_render`, :func:`nonuniform_spectra`) are
the training surface, as in the JAX package: they are differentiable in
reverse and in forward mode through the kernels
(:mod:`~bbcat_dsp_torch.ops.autograd`), in the IRs, the spectra, the
signal and the state.  :class:`NonUniformConvolver` keeps its filters and
buffers out of autograd (``process_small_block`` gathers its super-block
in place): it streams, it does not train.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import ops_hook
from ..ops.autograd import needs_derivative
from .block import (
    ConvolverState,
    _ramp,
    _roll_slots,
    convolver_init,
    ir_spectra,
    partition_ir,
)
from ..utils.precision import storage_dtype
from ..utils.profiling import span
from .fft import half_window_signs, spectral_nbins

__all__ = [
    "NonUniformState",
    "NonUniformConvolver",
    "nonuniform_render",
    "nonuniform_render_looped",
    "nonuniform_spectra",
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


def nonuniform_spectra(ir: torch.Tensor, block: int, ratio: int = 8):
    """``(H_head, H_tail)`` of IRs ``[C, N]`` (or ``[N]``) for the engine
    at ``block`` and ``ratio``, on the IRs' device and differentiable: the
    tensor counterpart of :class:`NonUniformConvolver`'s spectra.  The
    first ``2 * ratio * block`` taps go to the head's ``2 * ratio``
    partitions of ``block``, the rest to as many partitions of ``ratio *
    block`` as they fill."""
    ir2 = ir if ir.dim() == 2 else ir[None]
    n1 = 2 * ratio * block
    tail = ir2[:, n1:]
    if tail.shape[1] == 0:
        tail = ir2.new_zeros((ir2.shape[0], 1))
    return (ir_spectra(ir2[:, :n1], block, 2 * ratio),
            ir_spectra(tail, ratio * block))


def _head_step(xcarry, prev, H_head, x, block: int):
    """Head over ``x [C, k*block]``: ``(y_head, xcarry', prev')``."""
    return ops_hook.fused_head(x, xcarry, prev, H_head, block)


def _head_spectra(prev_xt: torch.Tensor, x: torch.Tensor, B: int,
                  ratio: int):
    """Window spectra of the ``ratio`` blocks of ``x [C, ratio*B]`` by the
    half-window shift theorem, one K3 launch for all of them: ``(X [2,
    ratio, C, F], new_prev_xt [2, C, F])``."""
    C = x.shape[0]
    xb = x.reshape(C, ratio, B).transpose(0, 1).contiguous()  # [ratio, C, B]
    xt = ops_hook.rfft_half(xb, 2 * B)                        # [2, ratio, C, F]
    ext = torch.cat([prev_xt[:, None], xt], dim=1)
    s = half_window_signs(2 * B, x.device)
    return ext[:, :-1] + s * ext[:, 1:], xt[:, -1].contiguous()


def _head_history(xcarry, prev, x, B: int, ratio: int):
    """``(xext [2, P+ratio, C, F], prev')``: the carried window spectra
    followed by those of the ``ratio`` new blocks."""
    Xnew, prev_xt = _head_spectra(prev, x, B, ratio)
    return torch.cat([xcarry, Xnew], dim=1), prev_xt


def _tail_step_xt(state: ConvolverState, H, x, H_old=None,
                  in_place: bool = False):
    """One tail super-step over ``x [C, B2]``: ``(state', y [C, B2])``,
    K3, K2s, K4.  With ``H_old`` the step fades from the old filter to
    ``H`` over the super-block, ``r[k] = (k + 1) / B2``.  With
    ``in_place`` the caller owns ``state.queue``: K2s's launch writes the
    new half spectrum into its oldest slot and ``state'`` holds the same
    tensor, unless the step records a derivative; otherwise ``state'``
    holds a new queue."""
    with span("nonuniform.tail_step", x.device):
        B2 = x.shape[-1]
        queue = state.queue
        xt = ops_hook.rfft_half(x, 2 * B2)             # [2, C, F]
        slot = state.step % queue.shape[1]             # the oldest slot
        fade = () if H_old is None else (H_old,)
        retire = in_place and not needs_derivative(queue, xt, H, *fade)
        if H_old is not None:  # reads the queue before the slot is written
            y_old = ops_hook.irfft_tail(
                ops_hook.xt_step_mac(queue, xt, H_old, slot), 2 * B2)
        y = ops_hook.irfft_tail(
            ops_hook.xt_step_mac(queue, xt, H, slot, retire), 2 * B2)
        if H_old is not None:
            r = _ramp(B2, x.device)
            y = (1 - r) * y_old + r * y
        if not retire:
            queue = queue.clone()
            queue[:, slot] = xt.to(queue.dtype)  # the one rounding
        return ConvolverState(queue, xt, state.step + 1), y


def _head_step_mac(xcarry, prev, H, x, block: int, H_old=None):
    """Head over ``x [C, k*block]``, any ``k >= 1``, by K3, K7 and K4 in
    place of K1: ``(y_head [C, k*block], xcarry', prev')``.  With
    ``H_old`` the first small block fades from the old filter to ``H``
    over ``r[n] = (n + 1) / block``; the others run ``H`` alone."""
    C, T = x.shape
    k = T // block
    xext, prev = _head_history(xcarry, prev, x, block, k)
    y = ops_hook.irfft_tail(ops_hook.head_mac(xext, H, k),
                            2 * block)                    # [k, C, B]
    y0 = y[0]
    if H_old is not None:
        # the old filter for block 0 only: the MAC reads the first P + 1
        # slots of the whole history (no sliced copy)
        y_old0 = ops_hook.irfft_tail(ops_hook.head_mac(xext, H_old, 1),
                                     2 * block)[0]
        r = _ramp(block, x.device)
        y0 = (1 - r) * y_old0 + r * y0
        if k > 1:
            y = torch.cat([y0[None], y[1:]])
    # one small block is returned as it is, with no copy
    y_head = y0 if k == 1 else y.transpose(0, 1).reshape(C, T)
    return y_head, xext[:, -H.shape[1]:].contiguous(), prev


def _super_step(state: NonUniformState, H_head, H_tail, x, block: int,
                in_place: bool = False, H_old=None):
    """One super-block ``x [C, B2]`` -> ``y [C, B2]``; ``in_place`` as
    :func:`_tail_step_xt` takes it.  ``H_old = (H_head_old, H_tail_old)``
    makes it the super-block in which an IR exchange begins: the head fades
    over its first small block (K3, K7, K4 in place of K1), the tail over
    the whole super-block."""
    if H_old is None:
        y_head, xcarry, prev = _head_step(state.xcarry, state.prev, H_head,
                                          x, block)
        H_tail_old = None
    else:
        y_head, xcarry, prev = _head_step_mac(state.xcarry, state.prev,
                                              H_head, x, block, H_old[0])
        H_tail_old = H_old[1]
    y = y_head + state.pending[0]
    tail, out_tail = _tail_step_xt(state.tail, H_tail, x, H_old=H_tail_old,
                                   in_place=in_place)
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


def _no_buffer():
    """The engine's buffer when it holds none: every queue is copied."""
    return None


class NonUniformConvolver:
    """Streaming two-level partitioned convolver with click-free IR
    exchange.

    ``ir [C, N]`` (or ``[N]``, broadcast to ``nchannels``) as a numpy
    array; every tensor lives on ``device``.  Three ways in, which continue
    the same stream:

    - :meth:`process` renders ``[C, T]``, T a multiple of ``ratio *
      block``, batched over whole render groups;
    - :meth:`process_block` takes one super-block ``[C, ratio * block]``;
    - :meth:`process_small_block` takes one small block ``[C, block]``,
      the low-latency path: the head runs every block, the tail once a
      super-block has gathered.

    :meth:`set_filter` schedules an exchange that the next
    ``process_block`` or ``process_small_block`` fades in; ``process``
    leaves it scheduled, as the reference does.  ``dtype`` is the tail
    queue's storage type: float32, or bfloat16 or float16, with which only
    :meth:`process_block` runs (the other two raise ``ValueError``, where
    the reference's raise ``TypeError``).

    ``process_block`` and ``process_small_block`` write the tail queue in
    place at each tail step, while the engine alone holds it.  A state
    read from :attr:`state` or assigned to it is a value, as the
    reference's is: the engine copies its queue once, at the next tail
    step, and never writes the state it handed out or was handed."""

    def __init__(self, ir, block: int, ratio: int = 8,
                 nchannels: int | None = None, dtype=torch.float32, *,
                 device):
        self.dtype = storage_dtype(dtype, "queue")
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
        self.head_parts = 2 * self.ratio
        tail = _split_ir(ir2, self.block, self.ratio)[1]
        self.tail_parts = (1 if tail is None else
                           max(1, -(-tail.shape[1] // self.super_block)))
        self.H_head, self.H_tail = self._spectra(ir2)
        self._pending_swap = None
        self._tail_swap = None
        self.reset()

    def _spectra(self, ir2):
        """``(H_head, H_tail)`` of IRs ``[C', N]`` at this engine's sizes."""
        head, tail = _split_ir(ir2, self.block, self.ratio)
        if tail is None:
            tail = np.zeros((ir2.shape[0], 1))
        return (partition_ir(head, self.block, self.head_parts,
                             device=self.device),
                partition_ir(tail, self.super_block, self.tail_parts,
                             device=self.device))

    def set_filter(self, ir, channel: int | None = None) -> None:
        """Click-free IR exchange, starting at the next (small or super)
        block.  ``channel=None`` replaces all channels (``ir`` shaped like
        the constructor's); otherwise one channel's IR ``[N]``.
        Per-channel exchanges before one block stack."""
        if channel is None:
            ir2 = np.atleast_2d(np.asarray(ir))
            if ir2.shape[0] == 1 and self.nchannels > 1:
                ir2 = np.broadcast_to(ir2, (self.nchannels, ir2.shape[1]))
            self._pending_swap = self._spectra(ir2)
            return
        one = self._spectra(np.atleast_2d(np.asarray(ir)))
        base = (self._pending_swap if self._pending_swap is not None
                else (self.H_head, self.H_tail))
        new = []
        for b, o in zip(base, one):
            b = b.clone()  # the base may be the filter the stream still runs
            b[:, :, channel] = o[:, :, 0]
            new.append(b)
        self._pending_swap = tuple(new)

    def _input(self, x, n: int, what: str) -> torch.Tensor:
        with span("nonuniform.input"):
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            if x.shape[-1] != n:
                raise ValueError(
                    f"{what} of {x.shape[-1]} samples, expected {n}")
            return x.contiguous()

    def _float32_only(self, call: str) -> None:
        if self.dtype != torch.float32:
            raise ValueError(
                f"{call} on a {self.dtype} engine: the reference's narrow "
                f"two-level engine fails there with a TypeError (a carry "
                f"that changes type), so the port runs only process_block "
                f"with a narrow tail queue; build the engine in float32 for "
                f"{call}")

    def _widened(self, st: NonUniformState) -> NonUniformState:
        """``st`` with every leaf but the tail queue in float32: the
        kernels' operands (a state file of a fresh narrow JAX engine holds
        them narrow, all zeros)."""
        return NonUniformState(st.xcarry.float(), st.prev.float(),
                               st.tail._replace(prev=st.tail.prev.float()),
                               st.pending.float())

    def process(self, x) -> torch.Tensor:
        """Whole-signal render of ``x [C, T]``."""
        with span("nonuniform.process", self.device):
            self._float32_only("process")
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            self._state, y = nonuniform_render(self._state, self.H_head,
                                               self.H_tail, x.contiguous(),
                                               self.block)
            return y

    @property
    def state(self) -> NonUniformState:
        """The stream's state.  Read or assigned, it is a value: the
        engine writes no queue that left it or came in this way."""
        self._queue = _no_buffer
        return self._state

    @state.setter
    def state(self, st: NonUniformState) -> None:
        self._queue = _no_buffer
        self._state = st

    def _owned(self, st: NonUniformState) -> NonUniformState:
        """``st`` with its tail queue in the engine's own buffer, which a
        streaming tail step writes in place; a queue the engine does not
        hold alone (a render group's, which ``tail.prev`` may view; one
        read from or assigned to :attr:`state`) is copied into a fresh
        buffer first.  The engine holds its buffer weakly: one the state
        has let go of is freed."""
        if st.tail.queue is self._queue():
            return st
        queue = st.tail.queue.clone(memory_format=torch.contiguous_format)
        self._queue = weakref.ref(queue)
        return st._replace(tail=st.tail._replace(queue=queue))

    def process_block(self, x) -> torch.Tensor:
        """One super-block ``x [C, ratio * block]`` -> its output."""
        x = self._input(x, self.super_block, "super-block")
        if self._sb_fill:
            raise ValueError("process_block cannot start mid-way through "
                             "a super-block of small blocks")
        st = self._owned(self._state)
        if self.dtype != torch.float32:
            st = self._widened(st)
        swap = self._pending_swap
        H_old = None if swap is None else (self.H_head, self.H_tail)
        H_head, H_tail = swap or (self.H_head, self.H_tail)
        self._state, y = _super_step(st, H_head, H_tail, x, self.block,
                                     in_place=True, H_old=H_old)
        self.H_head, self.H_tail = H_head, H_tail
        self._pending_swap = None
        return y

    def process_small_block(self, x) -> torch.Tensor:
        """Low-latency streaming: one small block ``x [C, block]`` in and
        out.  An exchange fades the head in over this block and the tail
        over its next firing."""
        with span("nonuniform.small_block"):
            self._float32_only("process_small_block")
            B = self.block
            x = self._input(x, B, "small block")
            st = self._state
            swap = self._pending_swap
            H_old = None if swap is None else self.H_head
            H_head = self.H_head if swap is None else swap[0]
            with span("nonuniform.head_step"):
                y_head, xcarry, prev = _head_step_mac(
                    st.xcarry, st.prev, H_head, x, B, H_old)
            if swap is not None:
                self.H_head, self._tail_swap = swap
                self._pending_swap = None
            off = self._sb_fill * B
            y = y_head + st.pending[0][:, off:off + B]
            self._sb_buf[:, off:off + B] = x  # in place: the buffer is ours
            self._sb_fill += 1
            tail, pending = st.tail, st.pending
            if self._sb_fill == self.ratio:
                tail = self._owned(st).tail
                if self._tail_swap is not None:
                    tail, out_tail = _tail_step_xt(
                        tail, self._tail_swap, self._sb_buf,
                        H_old=self.H_tail, in_place=True)
                    self.H_tail, self._tail_swap = self._tail_swap, None
                else:
                    tail, out_tail = _tail_step_xt(tail, self.H_tail,
                                                   self._sb_buf,
                                                   in_place=True)
                pending = torch.stack([st.pending[1], out_tail])
                self._sb_fill = 0
            self._state = NonUniformState(xcarry, prev, tail, pending)
            return y

    def reset(self) -> None:
        """Restart the stream from silence, the tail queue in the engine's
        ``dtype`` (the reference's ``reset`` takes the type of ``prev``,
        float32 after a block).  An exchange still scheduled, or whose tail
        half has not fired yet, takes effect at once: there is no past
        output left to fade from."""
        if self._pending_swap is not None:
            self.H_head, self._tail_swap = self._pending_swap
        if self._tail_swap is not None:
            self.H_tail = self._tail_swap
        self._pending_swap = self._tail_swap = None
        C, dev = self.nchannels, self.device
        F = spectral_nbins(2 * self.block)
        self._sb_buf = torch.zeros((C, self.super_block), device=dev)
        self._sb_fill = 0
        self._state = NonUniformState(
            xcarry=torch.zeros((2, self.head_parts, C, F), device=dev),
            prev=torch.zeros((2, C, F), device=dev),
            tail=convolver_init(C, self.super_block, self.tail_parts,
                                self.dtype, device=dev)._replace(
                prev=torch.zeros((2, C, spectral_nbins(2 * self.super_block)),
                                 device=dev)),
            pending=torch.zeros((2, C, self.super_block), device=dev),
        )
        self._queue = weakref.ref(self._state.tail.queue)  # its own buffer
