"""A Schroeder reverberator: the counterpart of the JAX package's
``models/reverb.py``.

Four feedback combs side by side (a dense modal response; each comb's gain
set from the decay time), then three all-passes one after the other (echo
density).  Every element is a scan over its delay's phases
(:mod:`~bbcat_dsp_torch.filters.allpass`): no loop over samples.
"""

from __future__ import annotations

import torch

from ..filters.allpass import allpass_apply, comb_apply

__all__ = ["SchroederReverb"]

# the classic tunings at 25 kHz, scaled to fs (mutually prime)
_COMB_DELAYS_25K = (1557, 1617, 1491, 1422)
_ALLPASS_DELAYS_25K = (225, 556, 441)
_ALLPASS_COEFF = 0.7


class SchroederReverb:
    """A streaming reverb over ``nchannels`` channels on ``device``.

    ``rt60`` is the decay time in seconds, ``mix`` the wet share, ``spread``
    the offset of the comb delays from one channel to the next, which
    decorrelates the channels.  The delays differ from channel to channel,
    so each channel runs its seven elements on its own: seven calls a
    channel a block."""

    def __init__(self, nchannels: int, fs: float = 48000.0,
                 rt60: float = 1.2, mix: float = 0.3, spread: int = 23,
                 dtype=torch.float32, *, device):
        self.fs = fs
        self.mix = float(mix)
        self.nchannels = nchannels
        self.dtype = dtype
        self.device = torch.device(device)
        scale = fs / 25000.0
        # the same decay on every channel, other modes
        self.comb_delays = [
            tuple(int(round(d0 * scale)) + spread * c
                  for c in range(nchannels)) for d0 in _COMB_DELAYS_25K]
        # g = 10^(-3 d / (rt60 fs)): -60 dB after rt60 seconds
        self.comb_gains = [tuple(10.0 ** (-3.0 * d / (rt60 * fs)) for d in ds)
                           for ds in self.comb_delays]
        # all-pass delays of their own too: the comb offsets alone leave
        # the early field correlated between channels
        self.ap_delays = [
            tuple(int(round(d * scale)) + 7 * c for c in range(nchannels))
            for d in _ALLPASS_DELAYS_25K]
        self.reset()

    def process_block(self, x) -> torch.Tensor:
        """``x [C, B]`` -> the dry and wet mix ``[C, B]``."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        wet = torch.zeros_like(x)
        for ci, (ds, gs) in enumerate(zip(self.comb_delays, self.comb_gains)):
            outs = []
            for c in range(self.nchannels):
                y, self._comb_rings[ci][c] = comb_apply(
                    x[c:c + 1], gs[c], ds[c], self._comb_rings[ci][c])
                outs.append(y)
            wet = wet + torch.cat(outs, 0)
        wet = wet / len(self.comb_delays)
        for ai, ds in enumerate(self.ap_delays):
            outs = []
            for c in range(self.nchannels):
                y, self._ap_rings[ai][c] = allpass_apply(
                    wet[c:c + 1], _ALLPASS_COEFF, ds[c], self._ap_rings[ai][c])
                outs.append(y)
            wet = torch.cat(outs, 0)
        return (1.0 - self.mix) * x + self.mix * wet

    def reset(self) -> None:
        def rings(delays):
            return [[torch.zeros((1, d), dtype=self.dtype, device=self.device)
                     for d in ds] for ds in delays]

        self._comb_rings = rings(self.comb_delays)
        self._ap_rings = rings(self.ap_delays)
