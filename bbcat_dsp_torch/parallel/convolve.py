"""Sharded partitioned convolution: channel-parallel and time-parallel.

The counterpart of the JAX package's ``parallel/convolve.py``.  Where JAX
builds a ``shard_map`` over global arrays, each function here returns a
callable on this rank's local tensors, run by every rank of the mesh (SPMD
over a process group):

* **Channel sharding**: each rank holds a contiguous channel slice of the
  state, the IR spectra and the signal, and runs the single-process
  engine on it with no communication (channels are independent).
* **Time sharding** (offline render): each rank holds a contiguous span
  of the signal.  Overlap-save needs the input that precedes the span, so
  each rank receives its left neighbour's trailing samples
  (:func:`~bbcat_dsp_torch.parallel.comms.halo_exchange`), rebuilds the
  engine's state from them and renders its span as the sequential stream
  would.

Both compose on a 2-D ``("ch", "t")`` mesh: the local tensors are then a
channel slice of a time span, and the halo moves along ``"t"`` only.  On
CUDA tensors every step runs through the port's kernels
(:mod:`~bbcat_dsp_torch.ops_hook`), as the single-process engines do; a
callable takes a signal that is a view (a block or a span of a longer
one) and hands the kernels a contiguous copy.
"""

from __future__ import annotations

import torch

from .. import ops_hook
from ..convolve.block import ConvolverState, convolver_render, convolver_step
from ..convolve.fft import half_window_signs
from ..convolve.nonuniform import NonUniformState, nonuniform_render
from .comms import halo_exchange

__all__ = [
    "channel_sharded_step",
    "channel_sharded_render",
    "channel_sharded_nonuniform_render",
    "time_sharded_render",
    "time_sharded_nonuniform_render",
]


def _on_mesh(mesh, **tensors) -> None:
    """Refuse operands that do not lie on the mesh's device."""
    for name, t in tensors.items():
        if t.device != mesh.device:
            raise ValueError(f"{name} is on {t.device}, the mesh's shards on "
                             f"{mesh.device}")


def channel_sharded_step(mesh, axis_name: str = "ch"):
    """``(state, H, x) -> (state', y)``: one block of this rank's channels
    through :func:`~bbcat_dsp_torch.convolve.convolver_step` (K3, K9, K4),
    no collective.  ``state`` holds the local channels (``shard_state``);
    ``H [2, P, C_local, F]``; ``x [C_local, B]``."""
    mesh.size(axis_name)

    def step(state: ConvolverState, H, x):
        _on_mesh(mesh, H=H, x=x)
        return convolver_step(state, H, x.contiguous())

    return step


def channel_sharded_render(mesh, block: int, axis_name: str = "ch"):
    """As :func:`channel_sharded_step`, a whole ``[C_local, T]`` signal
    through :func:`~bbcat_dsp_torch.convolve.convolver_render` (K3, K7,
    K4)."""
    mesh.size(axis_name)

    def render(state: ConvolverState, H, x):
        _on_mesh(mesh, H=H, x=x)
        return convolver_render(state, H, x, block)

    return render


def channel_sharded_nonuniform_render(mesh, block: int,
                                      axis_name: str = "ch"):
    """``(state, H_head, H_tail, x) -> (state', y)``: the two-level render
    (:func:`~bbcat_dsp_torch.convolve.nonuniform_render`: K1, K5, K3, K2,
    K4, K6) of this rank's channels, no collective; BASELINE config #5's
    path.  The render takes its queue slot from the state's host
    ``tail.step``, so a shard may continue a stream at any slot."""
    mesh.size(axis_name)

    def render(state: NonUniformState, H_head, H_tail, x):
        _on_mesh(mesh, H_head=H_head, H_tail=H_tail, x=x)
        return nonuniform_render(state, H_head, H_tail, x.contiguous(), block)

    return render


def _check_span(T_local: int, unit: int, what: str, halo_len: int) -> None:
    if T_local % unit or T_local == 0:
        raise ValueError(f"a rank's span must be a whole number of {what} "
                         f"({unit} samples): got {T_local}")
    if T_local < halo_len:
        raise ValueError(f"a rank's span must cover the halo, which comes "
                         f"from the left neighbour alone: span {T_local} < "
                         f"halo {halo_len}")


def time_sharded_render(mesh, block: int, nparts: int, axis_name: str = "t",
                        ch_axis: str | None = None):
    """``(H, x) -> y``: the uniform render of this rank's time span ``x
    [C_local, T_local]`` (a multiple of ``block``, at least the halo).  The
    rank receives its left neighbour's trailing ``nparts * block`` samples,
    rebuilds the spectral queue from those halo blocks (one K3 launch; the
    window spectra by the shift theorem), starts its stream at ``step =
    nparts`` and renders (K3, K7, K4); its output equals the sequential
    stream's from silence.  ``ch_axis`` names the mesh axis the channels
    are cut over, if any: the halo moves along ``axis_name`` only."""
    group = mesh.group(axis_name)
    if ch_axis is not None:
        mesh.size(ch_axis)
    halo_len = nparts * block

    def render(H, x):
        _on_mesh(mesh, H=H, x=x)
        C, T_local = x.shape
        if H.shape[1] != nparts:
            raise ValueError(f"H has {H.shape[1]} partitions, the render "
                             f"was built for {nparts}")
        _check_span(T_local, block, "blocks", halo_len)
        halo = halo_exchange(x[:, -halo_len:], group)
        # halo block k's half spectrum; the window that ends at block k
        # spans blocks k-1 and k (block -1 is the silence before the halo)
        hb = halo.reshape(C, nparts, block).transpose(0, 1).contiguous()
        xt = ops_hook.rfft_half(hb, 2 * block)             # [2, P, C, F]
        before = torch.cat([torch.zeros_like(xt[:, :1]), xt[:, :-1]], 1)
        queue = before + half_window_signs(2 * block, x.device) * xt
        # at step = nparts the slot of the window p blocks back is
        # (nparts - p) % nparts: window k, nparts - k blocks back, is in
        # slot k, so the chronological stack is the queue
        state = ConvolverState(queue, xt[:, -1].contiguous(), nparts)
        return convolver_render(state, H, x, block)[1]

    return render


def time_sharded_nonuniform_render(mesh, block: int, ratio: int,
                                   head_parts: int, tail_parts: int,
                                   axis_name: str = "t",
                                   ch_axis: str | None = None):
    """``(H_head, H_tail, x) -> y``: the two-level render of this rank's
    time span ``x [C_local, T_local]``, a whole number of render groups
    (``tail_parts`` super-blocks of ``ratio * block``) and at least the
    halo of ``tail_parts + 2`` super-blocks, which the rank receives from
    its left neighbour in one exchange.  From the halo it rebuilds every
    piece of the engine's state at the span's start:

    * the tail queue, the raw half spectra of the last ``tail_parts`` halo
      super-blocks (slot-encoded at ``step = 0``, since a span is a whole
      number of groups): K5 and one K3 launch over the ``tail_parts + 2``
      super-blocks;
    * the 2-slot ``pending``, the tail outputs of the two super-steps
      before the span: a ``tail_parts``-deep MAC over the halo's windows
      (K7 at two outputs behind one never-read slot) and K4;
    * the head's carried window spectra and ``prev``, from the last
      ``head_parts + 1`` small blocks (one K3 launch);

    then renders (K1, K5, K3, K2, K4, K6).  Its output equals the
    sequential stream's from silence.  ``ch_axis`` as in
    :func:`time_sharded_render`."""
    group = mesh.group(axis_name)
    if ch_axis is not None:
        mesh.size(ch_axis)
    B, B2, Pt, Ph = block, block * ratio, tail_parts, head_parts
    halo_sup = Pt + 2
    halo_len = halo_sup * B2

    def render(H_head, H_tail, x):
        _on_mesh(mesh, H_head=H_head, H_tail=H_tail, x=x)
        C, T_local = x.shape
        if H_tail.shape[1] != Pt or H_head.shape[1] != Ph:
            raise ValueError(f"spectra of {H_head.shape[1]} head and "
                             f"{H_tail.shape[1]} tail partitions, the render "
                             f"was built for {Ph} and {Pt}")
        _check_span(T_local, Pt * B2, "render groups", halo_len)
        halo = halo_exchange(x[:, -halo_len:], group)
        # the tail: half spectra of the halo's super-blocks
        hsup = ops_hook.gather_supers(halo, halo_sup)       # [Pt+2, C, B2]
        t_half = ops_hook.rfft_half(hsup, 2 * B2)           # [2, Pt+2, C, F2]
        s2 = half_window_signs(2 * B2, x.device)
        w = t_half[:, :-1] + s2 * t_half[:, 1:]             # [2, Pt+1, C, F2]
        queue = t_half[:, 2:].contiguous()
        # pending[k] is the tail output of super-step k - 2 (k = 0, 1):
        # sum_p w[Pt - 1 + k - p] H[p]; the MAC's contract reads
        # ext[Pt + k - p], so one never-read slot goes in front
        ext = torch.cat([torch.zeros_like(w[:, :1]), w], 1)
        pending = ops_hook.irfft_tail(ops_hook.head_mac(ext, H_tail, 2),
                                      2 * B2)               # [2, C, B2]
        # the head: the window at small block m spans blocks m-1 and m
        hb = halo[:, -(Ph + 1) * B:].reshape(C, Ph + 1, B).transpose(
            0, 1).contiguous()
        h_half = ops_hook.rfft_half(hb, 2 * B)              # [2, Ph+1, C, F]
        s1 = half_window_signs(2 * B, x.device)
        xcarry = h_half[:, :-1] + s1 * h_half[:, 1:]        # [2, Ph, C, F]
        state = NonUniformState(
            xcarry=xcarry,
            prev=h_half[:, -1].contiguous(),
            tail=ConvolverState(queue, t_half[:, -1].contiguous(), 0),
            pending=pending,
        )
        return nonuniform_render(state, H_head, H_tail, x.contiguous(),
                                 B)[1]

    return render
