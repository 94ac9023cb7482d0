"""The streaming binaural (HRTF) renderer: per-channel EQ through the modal
IIR engine, a ``C_in x 2`` HRTF matrix convolution with click-free HRTF
exchange, and BS.1770 metering of the output.

The counterpart of the JAX package's ``models/binaural.py``.  Its output
reaches the meter through a buffer on the device: the host never waits on
a block, so the per-block latency is the path's own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convolve.block import ConvolverState, convolver_init
from ..convolve.matrix import (
    matrix_step,
    matrix_step_crossfade,
    partition_ir_matrix,
)
from ..filters.iir import modal_apply, modal_init, modal_params
from ..loudness import LoudnessMeter

__all__ = ["BinauralState", "binaural_init", "binaural_step",
           "BinauralRenderer"]


class BinauralState(NamedTuple):
    eq: tuple             # one ModalState per EQ stage, batch C_in
    conv: ConvolverState


def binaural_init(eq_params: tuple, nchannels: int, block: int, nparts: int,
                  *, device) -> BinauralState:
    return BinauralState(
        eq=tuple(modal_init(p, (nchannels,)) for p in eq_params),
        conv=convolver_init(nchannels, block, nparts, device=device),
    )


def _eq(eq_params: tuple, eq_states: tuple, x: torch.Tensor):
    y, new = x, []
    for p, s in zip(eq_params, eq_states):
        y, s2 = modal_apply(y, p, s)
        new.append(s2)
    return y.contiguous(), tuple(new)


def binaural_step(state: BinauralState, eq_params: tuple, H: torch.Tensor,
                  x: torch.Tensor):
    """One block: ``x [C_in, B]`` -> ``(state', y [2, B])``."""
    y, eq = _eq(eq_params, state.eq, x)
    conv, out = matrix_step(state.conv, H, y)
    return BinauralState(eq=eq, conv=conv), out


class BinauralRenderer:
    """EQ, HRTF matrix convolution and output metering on ``device``.

    ``hrtf [C_in, 2, N]`` as a numpy array; ``eq_stages`` an optional list
    of float64 ``[b0, b1, b2, a1, a2]`` rows, each applied to every input
    channel in turn."""

    def __init__(self, hrtf, block: int, eq_stages=None, fs: float = 48000.0,
                 nparts: int | None = None, *, device):
        self.device = torch.device(device)
        self.block = int(block)
        self.fs = fs
        self.H = partition_ir_matrix(hrtf, self.block, nparts,
                                     device=self.device)
        _, self.nparts, self.c_in, self.c_out = self.H.shape
        self.eq_params = tuple(modal_params(c, device=self.device)
                               for c in ([] if eq_stages is None
                                         else eq_stages))
        self.state = binaural_init(self.eq_params, self.c_in, self.block,
                                   self.nparts, device=self.device)
        self.meter = LoudnessMeter(self.c_out, fs, device=self.device)
        self._meter_buf = torch.zeros((self.c_out, 0), device=self.device)
        self._pending_H = None

    def set_hrtf(self, hrtf) -> None:
        """Schedule a click-free HRTF exchange at the next block."""
        self._pending_H = partition_ir_matrix(hrtf, self.block, self.nparts,
                                              device=self.device)

    def process_block(self, x) -> torch.Tensor:
        """``x [C_in, block]`` -> ``[2, block]``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != (self.c_in, self.block):
            raise ValueError(f"block of shape {tuple(x.shape)}, expected "
                             f"{(self.c_in, self.block)}")
        if self._pending_H is not None:
            y, eq = _eq(self.eq_params, self.state.eq, x)
            conv, out = matrix_step_crossfade(self.state.conv, self.H,
                                              self._pending_H, y)
            self.state = BinauralState(eq=eq, conv=conv)
            self.H, self._pending_H = self._pending_H, None
        else:
            self.state, out = binaural_step(self.state, self.eq_params,
                                            self.H, x.contiguous())
        self._feed_meter(out)
        return out

    def _feed_meter(self, out: torch.Tensor) -> None:
        """Hand the meter every whole 100 ms of output; keep the rest."""
        self._meter_buf = self.meter.process_buffered(self._meter_buf, out)

    def loudness(self) -> dict:
        return {
            "momentary_lkfs": self.meter.momentary(),
            "short_term_lkfs": self.meter.short_term(),
            "integrated_lkfs": self.meter.integrated(),
        }
