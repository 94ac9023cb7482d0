"""The format conversion, gain-matrix mixdown and loudness pipeline.

The counterpart of ``MixdownPipeline`` in the JAX package's
``models/pipeline.py``; its ``EQDelayPipeline`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.device import float_to_int32, int32_to_float
from ..formats.sample_format import SampleFormat, is_sample_integer
from ..loudness import LoudnessMeter
from ..utils.precision import full_f32

__all__ = ["MixdownPipeline"]


class MixdownPipeline:
    """Format conversion, gain-matrix mixdown and BS.1770 loudness of the
    mix, on ``device``.

    Input blocks ``[C_in, B]`` come as MSB-aligned int32 or float32 (by
    ``in_format``); ``gains [C_out, C_in]`` mix them at full float32; the
    mix goes out in ``out_format`` and its float32 form feeds the meter,
    through a buffer on the device."""

    def __init__(self, gains, fs: float = 48000.0,
                 in_format: SampleFormat = SampleFormat.FLOAT,
                 out_format: SampleFormat = SampleFormat.FLOAT, *, device):
        self.device = torch.device(device)
        self.gains = torch.as_tensor(np.asarray(gains, np.float32),
                                     device=self.device)
        self.in_format = in_format
        self.out_format = out_format
        c_out = self.gains.shape[0]
        self.meter = LoudnessMeter(c_out, fs, device=self.device)
        self._buf = torch.zeros((c_out, 0), device=self.device)

    def process_block(self, x) -> torch.Tensor:
        """One block ``[C_in, B]`` in ``in_format`` -> ``[C_out, B]`` in
        ``out_format``."""
        x = torch.as_tensor(x, device=self.device)
        x = int32_to_float(x) if is_sample_integer(self.in_format) else x.float()
        with full_f32():
            y = torch.matmul(self.gains, x)
        if is_sample_integer(self.out_format):
            y = float_to_int32(y)
            yf = int32_to_float(y)
        else:
            yf = y
        self._buf = self.meter.process_buffered(self._buf, yf)
        return y

    def integrated_loudness(self) -> float:
        return self.meter.integrated()
