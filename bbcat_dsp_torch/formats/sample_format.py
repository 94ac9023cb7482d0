"""Sample format taxonomy, with the reference enum's integer values.

On the device every integer format is carried as MSB-aligned int32 (a
16-bit sample in the top 16 bits, a 24-bit one in the top 24) and every
float format as float32.  Packed byte formats (3-byte int24, either byte
order) exist only at the host edge, :mod:`~bbcat_dsp_torch.formats.host`.
The counterpart of the JAX package's ``formats/sample_format.py``: the
same tables, clamps and integer values.
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = ["SampleFormat", "SAMPLE_FORMAT_COUNT", "is_sample_integer",
           "is_sample_float", "get_bits_per_sample", "get_bytes_per_sample",
           "sample_format_of", "block_transfer_sanity_checks"]


class SampleFormat(enum.IntEnum):
    """Audio sample formats."""

    UNKNOWN = 0
    INT16 = 1
    INT24 = 2
    INT32 = 3
    FLOAT = 4
    DOUBLE = 5


SAMPLE_FORMAT_COUNT = 6

_BITS = {SampleFormat.UNKNOWN: 0, SampleFormat.INT16: 16,
         SampleFormat.INT24: 24, SampleFormat.INT32: 32,
         SampleFormat.FLOAT: 32, SampleFormat.DOUBLE: 64}
_BYTES = {fmt: bits // 8 for fmt, bits in _BITS.items()}

_NP_DTYPES = {
    np.dtype(np.int16): SampleFormat.INT16,
    np.dtype(np.int32): SampleFormat.INT32,
    np.dtype(np.float32): SampleFormat.FLOAT,
    np.dtype(np.float64): SampleFormat.DOUBLE,
}


def is_sample_integer(fmt: SampleFormat) -> bool:
    return SampleFormat.INT16 <= fmt <= SampleFormat.INT32


def is_sample_float(fmt: SampleFormat) -> bool:
    return SampleFormat.FLOAT <= fmt <= SampleFormat.DOUBLE


def get_bits_per_sample(fmt: SampleFormat) -> int:
    return _BITS[SampleFormat(fmt)]


def get_bytes_per_sample(fmt: SampleFormat) -> int:
    return _BYTES[SampleFormat(fmt)]


def sample_format_of(x) -> SampleFormat:
    """The format of a numpy array or dtype of either byte order; packed
    int24 has no dtype (it travels as uint8 with its format beside it), so
    an unknown dtype is ``UNKNOWN``."""
    dt = x.dtype if isinstance(x, np.ndarray) else np.dtype(x)
    return _NP_DTYPES.get(dt.newbyteorder("="), SampleFormat.UNKNOWN)


def block_transfer_sanity_checks(
    src_channel: int,
    src_channels: int,
    dst_channel: int,
    dst_channels: int,
    nchannels: int,
    nframes: int,
    allow_single_channel: bool = True,
) -> tuple[bool, int, int, int, int]:
    """Clamp a rectangular transfer to what both buffers hold.

    The channel count is clamped to what both buffers can supply; a
    transfer that covers every channel of both buffers from channel 0
    collapses into one frame of ``nchannels * nframes`` channels, unless
    ``allow_single_channel`` is False (a ditherer must see true channel
    indices).  Returns ``(valid, src_channel, dst_channel, nchannels,
    nframes)``."""
    if src_channel >= src_channels or dst_channel >= dst_channels:
        return (False, src_channel, dst_channel, 0, 0)
    nchannels = min(nchannels, src_channels - src_channel,
                    dst_channels - dst_channel)
    if (allow_single_channel and nchannels == src_channels
            and nchannels == dst_channels and src_channel == 0
            and dst_channel == 0):
        nchannels *= nframes
        nframes = 1
    valid = nchannels > 0 and nframes > 0
    return (valid, src_channel, dst_channel, nchannels, nframes)
