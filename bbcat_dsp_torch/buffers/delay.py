"""Multichannel delay and ring buffers with sample-format edges.

The counterpart of the JAX package's ``buffers/delay.py``: a ``[C, L]``
ring on the device (:mod:`~bbcat_dsp_torch.buffers.ring`), float32 or,
with ``dtype``, bfloat16 or float16 (a write rounds to it, a read returns
it), and packed sample formats only at the host edge (``write_packed`` /
``read_packed`` through :mod:`~bbcat_dsp_torch.formats.host`, which read
and write float32 frames).

* :class:`SoundDelayBuffer` writes at a cursor and reads ``delay`` frames
  behind it, any number of times.
* :class:`SoundRingBuffer` adds a read cursor that consumes, with the
  reference's availability clamps (frames to read ``(w - r) mod L``,
  frames free ``(r - w - 1) mod L``).
* ``set_size`` keeps the newest contents, each the same distance behind
  the cursor.

Both cursors are host integers, and every place in the ring is computed
from them modulo the length in integers, so a stream of any length reads
the samples it wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.host import transfer_samples
from ..formats.sample_format import SampleFormat, get_bytes_per_sample
from .ring import Ring, ring_advance, ring_init, ring_write

__all__ = ["SoundDelayBuffer", "SoundRingBuffer"]


def _read_wrapped(data: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """``n`` frames of ring ``data [C, L]`` from place ``start``, wrapping
    as often as ``n`` needs: ``[C, n]``, a new tensor."""
    L = data.shape[-1]
    if start + n <= L:
        return data[:, start:start + n].clone()
    if n <= L:
        return torch.cat([data[:, start:], data[:, :start + n - L]], -1)
    idx = torch.remainder(torch.arange(start, start + n, device=data.device), L)
    return data.index_select(-1, idx)


class SoundDelayBuffer:
    """A delay line: one write cursor, delayed reads that consume
    nothing."""

    def __init__(self, nchannels: int, length: int, dtype=torch.float32, *,
                 device):
        self.nchannels = nchannels
        self.length = int(length)
        self.ring = ring_init((nchannels,), self.length, dtype, device=device)

    @property
    def write_position(self) -> int:
        return self.ring.writepos

    def set_size(self, length: int) -> None:
        """Resize, keeping the newest ``min(old, new)`` frames, each the
        same number of frames behind the (unchanged) cursor."""
        length = int(length)
        keep = min(self.length, length)
        w = self.ring.writepos
        frames = _read_wrapped(self.ring.data, (w - keep) % self.length, keep)
        data = torch.zeros((self.nchannels, length), dtype=frames.dtype,
                           device=frames.device)
        self.length = length
        self.ring = ring_write(Ring(data, w - keep), frames)

    def write(self, block: torch.Tensor) -> None:
        """Append ``[C, B]`` frames at the write cursor."""
        self.ring = ring_write(self.ring, block)

    def read(self, delay: int, nframes: int) -> torch.Tensor:
        """``nframes`` frames from ``delay`` frames behind the write cursor,
        at most ``delay`` of them: ``[C, n]``."""
        n = min(nframes, delay)
        return _read_wrapped(self.ring.data,
                             (self.ring.writepos - delay) % self.length, n)

    def read_sample(self, channel: int, delay: int) -> float:
        """One sample, ``delay`` frames behind the cursor."""
        return float(self.ring.data[channel,
                                    (self.ring.writepos - delay) % self.length])

    def write_packed(self, raw: np.ndarray, fmt: SampleFormat,
                     big_endian: bool, src_channel: int, nchannels: int,
                     nframes: int) -> None:
        """Interleaved packed frames of ``nchannels`` channels, from
        ``src_channel`` on, into this buffer's first channels at the
        cursor; channels past them are written silent."""
        nch = min(nchannels, self.nchannels)
        flt = np.zeros(nframes * nch * 4, np.uint8)
        transfer_samples(np.asarray(raw), fmt, big_endian, src_channel,
                         nchannels, flt, SampleFormat.FLOAT, False, 0, nch,
                         nch, nframes)
        block = np.zeros((self.nchannels, nframes), np.float32)
        block[:nch] = flt.view(np.float32).reshape(nframes, nch).T
        self.write(torch.from_numpy(block).to(self.ring.data.device))

    def read_packed(self, fmt: SampleFormat, big_endian: bool, delay: int,
                    nframes: int) -> np.ndarray:
        """Delayed frames as interleaved packed bytes (a narrow ring's
        frames widened to float32 first)."""
        frames = self.read(delay, nframes).T.float().contiguous().cpu().numpy()
        out = np.zeros(frames.size * get_bytes_per_sample(fmt), np.uint8)
        transfer_samples(frames.view(np.uint8).reshape(-1), SampleFormat.FLOAT,
                         False, 0, self.nchannels, out, fmt, big_endian, 0,
                         self.nchannels, self.nchannels, frames.shape[0])
        return out


class SoundRingBuffer(SoundDelayBuffer):
    """A FIFO: a read cursor that consumes, and writes and reads clamped to
    what is free and what is there."""

    def __init__(self, nchannels: int, length: int, dtype=torch.float32, *,
                 device):
        super().__init__(nchannels, length, dtype, device=device)
        self.readpos = 0

    def read_frames_available(self) -> int:
        return (self.ring.writepos - self.readpos) % self.length

    def write_frames_available(self) -> int:
        return (self.readpos - self.ring.writepos - 1) % self.length

    def write(self, block: torch.Tensor) -> int:
        """Write as much of ``block`` as is free; returns frames written."""
        n = min(block.shape[-1], self.write_frames_available())
        if n:
            super().write(block[..., :n])
        return n

    def read(self, nframes: int) -> torch.Tensor:
        """Consume up to ``nframes`` frames from the read cursor: ``[C,
        n]``, ``n`` possibly fewer."""
        n = min(nframes, self.read_frames_available())
        out = _read_wrapped(self.ring.data, self.readpos, n)
        self.readpos = (self.readpos + n) % self.length
        return out

    def increment_read_position(self, n: int) -> int:
        n = min(n, self.read_frames_available())
        self.readpos = (self.readpos + n) % self.length
        return n

    def increment_write_position(self, n: int) -> int:
        """Move the write cursor over ``n`` frames already in place, at
        most what is free."""
        n = min(n, self.write_frames_available())
        self.ring = ring_advance(self.ring, n)
        return n

    def reset_positions(self) -> None:
        self.ring = Ring(self.ring.data, 0)
        self.readpos = 0
