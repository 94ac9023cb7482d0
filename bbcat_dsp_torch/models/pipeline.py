"""Composed stream pipelines: the counterparts of the JAX package's
``models/pipeline.py``.

* :class:`EQDelayPipeline`: a static biquad EQ cascade and a fractional
  delay per channel (8 stages over 8 channels at 48 kHz in the BASELINE
  configuration).
* :class:`MixdownPipeline`: format conversion, gain-matrix mixdown and
  BS.1770 loudness of the mix.

Both take the JAX package's ``dtype`` (float32, bfloat16 or float16),
with its dtype flow.  ``EQDelayPipeline`` stores the cascade's parameters,
its initial state and the delay's ring in it: the cascade runs the narrow
parameters against the float32 block (its state is float32 after one),
the ring rounds what is written to it, and the output is the ring's read
in the narrow type.  ``MixdownPipeline`` stores the gains in it and mixes
them widened: its output is float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..buffers.ring import Ring, ring_init, ring_write
from ..filters.fractional import (
    ADDITIONAL_DELAY,
    fractional_read,
    fractional_read_stream,
)
from ..filters.iir import (
    ParallelCascadeState,
    modal_apply,
    modal_init,
    modal_params,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from ..formats.device import float_to_int32, int32_to_float
from ..formats.sample_format import SampleFormat, is_sample_integer
from ..loudness import LoudnessMeter
from ..utils.precision import full_f32, host_tensor, storage_dtype

__all__ = ["EQDelayPipeline", "EQDelayState", "MixdownPipeline"]


class EQDelayState(NamedTuple):
    eq: tuple | ParallelCascadeState   # the cascade's state, either form
    ring: Ring                         # the delay's ring [C, L]


class EQDelayPipeline:
    """A static EQ cascade and a fractional delay per channel, on
    ``device``.

    The whole cascade runs as one batched scan in its parallel
    (partial-fraction) form where that is well-conditioned, else stage by
    stage through the modal engine.  The delay reads ``delay`` samples
    behind the write head of a ring through the 14-tap, 128-phase
    polyphase table; the filter's own lag of about 7 samples comes on top,
    and the ring holds 14 samples of headroom beyond ``max_delay``.

    The write position lives on the host and is reduced modulo the ring's
    length in integers before it meets a float32 delay, so the delay's
    resolution does not degrade as the stream grows long."""

    def __init__(self, eq_coeffs, nchannels: int, block: int,
                 max_delay: float, fs: float = 48000.0, dtype=torch.float32,
                 *, device):
        eq_coeffs = np.atleast_2d(np.asarray(eq_coeffs, np.float64))
        self.device = torch.device(device)
        self.block = int(block)
        self.fs = fs
        self.dtype = dtype = storage_dtype(dtype, "pipeline")
        try:
            self.psos = parallel_cascade_params(eq_coeffs, dtype,
                                                device=self.device)
            self.params = None
        except ValueError:
            self.psos = None
            self.params = tuple(modal_params(c, device=self.device,
                                             dtype=dtype)
                                for c in eq_coeffs)
        L = int(np.ceil(max_delay)) + ADDITIONAL_DELAY + self.block
        # a power of two, as the JAX package rounds it
        self.length = 1 << int(np.ceil(np.log2(max(L, 2))))
        if self.params is None:
            z = torch.zeros((self.psos.pr.shape[0], nchannels), dtype=dtype,
                            device=self.device)
            eq0 = ParallelCascadeState(z, z)
        else:
            eq0 = tuple(modal_init(p, (nchannels,), dtype)
                        for p in self.params)
        self.state = EQDelayState(
            eq=eq0, ring=ring_init((nchannels,), self.length, dtype,
                                   device=self.device))

    def _step(self, state: EQDelayState, x: torch.Tensor,
              delays: torch.Tensor):
        if self.psos is not None:
            y, eq = parallel_cascade_apply(x, self.psos, state.eq)
        else:
            y, eq = x, []
            for p, s in zip(self.params, state.eq):
                y, s = modal_apply(y, p, s)
                eq.append(s)
            eq = tuple(eq)
        ring = ring_write(state.ring, y)
        B, L = x.shape[-1], self.length
        first = float((ring.writepos - B) % L)   # the block's first sample
        if delays.dim() > 1:
            # a delay per sample (doppler): the gather read
            wp = first + torch.arange(B, device=x.device, dtype=torch.float32)
            pos = torch.remainder(wp - delays + L, L)
            out = fractional_read(ring.data, pos)
        else:
            # one delay a channel: a 14-tap FIR with fixed taps
            start = torch.remainder(first - delays + L, L)
            out = fractional_read_stream(ring.data, start, B)
        return EQDelayState(eq=eq, ring=ring), out

    def process_block(self, x, delays) -> torch.Tensor:
        """``x [C, B]``; ``delays [C]`` (constant over the block) or ``[C,
        B]`` (one per sample), in samples."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        delays = torch.as_tensor(delays, dtype=torch.float32,
                                 device=self.device)
        self.state, y = self._step(self.state, x, delays)
        return y


class MixdownPipeline:
    """Format conversion, gain-matrix mixdown and BS.1770 loudness of the
    mix, on ``device``.

    Input blocks ``[C_in, B]`` come as MSB-aligned int32 or float32 (by
    ``in_format``); ``gains [C_out, C_in]`` mix them at full float32; the
    mix goes out in ``out_format`` and its float32 form feeds the meter,
    through a buffer on the device."""

    def __init__(self, gains, fs: float = 48000.0,
                 in_format: SampleFormat = SampleFormat.FLOAT,
                 out_format: SampleFormat = SampleFormat.FLOAT,
                 dtype=torch.float32, *, device):
        self.device = torch.device(device)
        self.gains = host_tensor(gains, storage_dtype(dtype, "gains"),
                                 self.device)
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
            # narrow gains widened: the reference mixes in float32
            y = torch.matmul(self.gains.float(), x)
        if is_sample_integer(self.out_format):
            y = float_to_int32(y)
            yf = int32_to_float(y)
        else:
            yf = y
        self._buf = self.meter.process_buffered(self._buf, yf)
        return y

    def integrated_loudness(self) -> float:
        return self.meter.integrated()
