"""Arbitrary-ratio resampling on the polyphase fractional reader.

The counterpart of the JAX package's ``filters/resample.py``: fractional
reads at a constant position increment are a polyphase resampler (128
phases, 14 taps; effective group delay 8 input samples).

* :func:`resample`: one-shot ratio conversion of ``[..., T]`` audio.
* :class:`Resampler`: streaming; feed input blocks and get every output
  sample that has become available, the fractional phase carried across
  blocks.

The table is an interpolation filter (anti-imaging, not anti-aliasing):
downsampling by more than about 1.5x needs a lowpass first.

``Resampler(dtype=...)`` stores its history in bfloat16 or float16, as
the JAX package's does: a history of zeros, read widened against a
float32 input, so the first block's output is float32 and the history
it keeps is float32 from then on (the reference's own dtype flow).

Positions are computed on the host and reach the device as float32: a
device's own float32 division may differ in the last bit, and that can
move a position to another phase.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import promoted, storage_dtype
from .fractional import ADDITIONAL_DELAY, fractional_read

__all__ = ["resample", "Resampler"]


def resample(x: torch.Tensor, ratio: float,
             n_out: int | None = None) -> torch.Tensor:
    """Resample ``x [..., T]`` by ``ratio`` (output rate over input rate).

    Output sample ``k`` is read at input position ``k / ratio``, in
    float32 as the JAX package computes it (plus the table's own lag of
    about 7 samples)."""
    T = x.shape[-1]
    if n_out is None:
        n_out = int(np.floor((T - ADDITIONAL_DELAY) * ratio))
    # x is read as one ring of length T
    pos = (np.arange(n_out, dtype=np.float32) / np.float32(ratio)
           + np.float32(ADDITIONAL_DELAY))
    return fractional_read(x, torch.from_numpy(pos).to(x.device))


class Resampler:
    """A streaming resampler that carries the exact fractional phase.

    ``process(block)`` takes ``[C, B]`` input and returns every output
    sample whose 14-tap support is complete: output block sizes vary by
    one sample as the phase accumulates."""

    def __init__(self, nchannels: int, ratio: float, block: int,
                 dtype=torch.float32, *, device):
        self.ratio = float(ratio)
        self.nchannels = nchannels
        self.block = int(block)
        # one block and the filter's headroom of history
        self.hist = torch.zeros((nchannels, ADDITIONAL_DELAY + self.block),
                                dtype=storage_dtype(dtype, "history"),
                                device=device)
        self._in_total = 0    # input samples consumed
        self._out_count = 0   # output samples emitted: positions derive
        # from this integer index, in float64, and are rounded once

    def process(self, x: torch.Tensor) -> torch.Tensor:
        """Feed ``[C, B]``; returns ``[C, n_k]`` resampled output."""
        B = x.shape[-1]
        keep = self.hist.shape[-1]
        dt = promoted(self.hist.dtype, x.dtype)
        buf = torch.cat([self.hist.to(dt), x.to(dt)], dim=-1)
        base = self._in_total - keep          # absolute position of buf[0]
        # every output k with k / ratio <= in_total + B
        k_end = int(np.floor((self._in_total + B) * self.ratio + 1e-9))
        n_out = max(0, k_end - self._out_count)
        if n_out:
            k = self._out_count + np.arange(n_out, dtype=np.float64)
            pos = (k / self.ratio - base).astype(np.float32)
            out = fractional_read(buf, torch.from_numpy(pos).to(buf.device))
            self._out_count += n_out
        else:
            out = buf[:, :0]
        self.hist = buf[:, -keep:]
        self._in_total += B
        return out
