"""Fractional-sample delay reads: a 14-tap, 128-phase polyphase windowed
sinc over a circular buffer.

The counterpart of the JAX package's ``filters/fractional.py``.  The index
contract is the reference's, computed in the same types and the same order
so that both packages pick the same phase and base for the same float32
position::

    phase = 128 - 1 - (floor(128 * pos) mod 128)
    base  = (floor(pos) + length - 14) mod length
    out   = sum_k table[phase, k] * buf[(base + k) mod length]

so the result lags about 7 samples (the filter's group delay).  A position
that differs in its last bit can land on another phase, so positions are
float32 throughout, ``mod`` on them is :func:`torch.remainder` (the sign
of the divisor), and callers reduce integer sample counts modulo the
buffer's length before they meet a float.

A buffer stored in bfloat16 or float16 reads as the JAX package reads it
there: the table rounded to the buffer's type, the output in that type.
:func:`fractional_read` rounds each of the 14 products, sums them in
float32 and rounds once; :func:`fractional_read_stream` accumulates tap by
tap in the narrow type, each product and each sum rounded.

The coefficient table is this package's own copy of the reference's filter
data, 1792 values that are exact multiples of 2^-23, stored as q23 int32
in ``data/polyphase_sinc_14x128_q23.npy`` (layout ``[tap * 128 + phase]``).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..buffers.ring import Ring, ring_write
from ..utils.precision import NARROW, storage_dtype, sum_in_order

__all__ = ["OVERSAMPLING", "TAPS", "ADDITIONAL_DELAY", "polyphase_table",
           "additional_delay_required", "fractional_read",
           "fractional_read_stream", "FractionalDelayLine"]

OVERSAMPLING = 128
TAPS = 14
ADDITIONAL_DELAY = TAPS   # headroom a buffer needs beyond its longest delay

_TABLE_FILE = Path(__file__).parent / "data" / "polyphase_sinc_14x128_q23.npy"


@functools.lru_cache(maxsize=None)
def polyphase_table() -> np.ndarray:
    """The 1792-entry filter table, float64, layout ``[tap * 128 +
    phase]`` (read-only: it is shared)."""
    table = np.load(_TABLE_FILE).astype(np.float64) * 2.0 ** -23
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def _table_phase_major(device: torch.device,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The table as ``[phase, tap]`` on ``device``, made once per device
    and type: float32 is exact (q23 values fit it), a narrow type rounds
    the float32 table."""
    t = polyphase_table().reshape(TAPS, OVERSAMPLING).T
    return torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(
        device).to(dtype)


def additional_delay_required() -> int:
    """Samples of headroom the reads need beyond the longest delay."""
    return ADDITIONAL_DELAY


def _phase_and_base(pos: torch.Tensor, length: int):
    """The polyphase phase and the first tap's place for float32 positions
    ``pos``: int64 tensors of ``pos``'s shape."""
    posf = pos.to(torch.float32)
    ipos = torch.floor(posf).to(torch.int64)
    phase = OVERSAMPLING - 1 - torch.remainder(
        torch.floor(posf * OVERSAMPLING).to(torch.int64), OVERSAMPLING)
    return phase, torch.remainder(ipos + (length - TAPS), length)


def fractional_read(buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Read fractional positions from a circular buffer.

    ``buf [..., length]`` is channel-major; ``pos [..., n]`` holds float
    positions and broadcasts against the leading axes of ``buf``.  Returns
    ``[..., n]`` samples: a gather of the 14 taps of every position and a
    weighted sum."""
    length = buf.shape[-1]
    phase, base = _phase_and_base(pos, length)
    taps = torch.arange(TAPS, device=buf.device)
    idx = torch.remainder(base[..., None] + taps, length)      # [..., n, 14]
    batch = torch.broadcast_shapes(buf.shape[:-1], idx.shape[:-2])
    n = idx.shape[-2]
    # gathered along the ring axis: no [..., n, length] copy of the ring
    flat = idx.expand(batch + (n, TAPS)).reshape(batch + (n * TAPS,))
    gathered = torch.gather(buf.expand(batch + (length,)), -1, flat)
    gathered = gathered.reshape(batch + (n, TAPS))
    weights = _table_phase_major(buf.device, buf.dtype)[phase]  # [..., n, 14]
    if buf.dtype in NARROW:
        # each product rounded to the narrow type, the sum in float32 and
        # rounded once, as the reference's jnp.sum of a narrow operand
        return sum_in_order(gathered * weights, -1).to(buf.dtype)
    return (gathered * weights).sum(-1)


def fractional_read_stream(buf: torch.Tensor, start_pos: torch.Tensor,
                           n: int | None = None,
                           out_len: int = 0) -> torch.Tensor:
    """Read ``out_len`` (or ``n``) consecutive positions a channel, from
    ``start_pos [...]`` on: the constant-delay case.

    Consecutive positions share one phase a channel, so this is a 14-tap
    FIR with fixed taps over one slab of ``out_len + 13`` samples a
    channel, taken from the ring with its wrap.  Equal to
    :func:`fractional_read` at positions one sample apart."""
    if n is not None:
        out_len = n
    length = buf.shape[-1]
    phase, base = _phase_and_base(start_pos, length)
    span = torch.arange(out_len + TAPS - 1, device=buf.device)
    slab = torch.gather(buf, -1, torch.remainder(base[..., None] + span,
                                                 length))
    w = _table_phase_major(buf.device, buf.dtype)[phase]       # [..., 14]
    if buf.dtype in NARROW:
        # tap by tap in the narrow type: each product and sum rounds to it
        out = torch.zeros_like(slab[..., :out_len])
        for k in range(TAPS):
            out = out + w[..., k, None] * slab[..., k:k + out_len]
        return out
    # windows of the slab as a view; the product is elementwise
    return (slab.unfold(-1, TAPS, 1) * w[..., None, :]).sum(-1)


class FractionalDelayLine:
    """A streaming fractional delay: a circular write head and fractional
    reads behind it.  The buffer must be at least the longest delay plus
    :data:`ADDITIONAL_DELAY` long.  ``dtype`` (float32, bfloat16 or
    float16) is the buffer's and the reads' type."""

    def __init__(self, nchannels: int, length: int, dtype=torch.float32, *,
                 device):
        self.length = int(length)
        self.buf = torch.zeros((nchannels, self.length),
                               dtype=storage_dtype(dtype, "buffer"),
                               device=device)
        self.writepos = 0   # samples written so far, on the host

    def write(self, block: torch.Tensor) -> None:
        """Append ``[C, B]`` samples at the write head."""
        ring = ring_write(Ring(self.buf, self.writepos), block)
        self.buf, self.writepos = ring

    def read(self, delays) -> torch.Tensor:
        """Read at fractional ``delays [C, n]`` (in samples) behind the
        write head; the filter's own lag of about 7 samples comes on top."""
        delays = torch.as_tensor(delays, dtype=torch.float32,
                                 device=self.buf.device)
        pos = (self.writepos % self.length) - delays + self.length
        return fractional_read(self.buf, torch.remainder(pos, self.length))
