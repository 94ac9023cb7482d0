"""Byte-level sample format conversion on the host.

The counterpart of the JAX package's ``formats/host.py``, with the same
numeric contract and so the same bytes:

* integer samples are MSB-aligned in a 32-bit register: int16 << 16,
  int24 << 8;
* int -> float: ``float(i32) * 2^-31``, the factor in the destination's
  float type;
* float -> int: ``clamp(x * 2^31, -2^31, 2^31 - 1)`` in float64, then a
  truncating cast;
* a narrowing integer write keeps the top bytes (an arithmetic shift);
* dither is added to the 32-bit register before a narrowing integer
  write, with ``bits`` the number of low bits about to go.

:func:`transfer_samples` takes the native C++ engine
(:mod:`~bbcat_dsp_torch.utils.native`) where it is built and no ditherer
is given, and a numpy path otherwise.  The numpy path gathers the source
rectangle through an int64 index of ``nframes x nchannels x bytes``
entries (~750 MB for 64 channels x 10 s of int24), which is why the
native engine comes first.
"""

from __future__ import annotations

import numpy as np

from ..utils import native
from .dither import Ditherer
from .sample_format import (
    SampleFormat,
    block_transfer_sanity_checks,
    get_bytes_per_sample,
    is_sample_integer,
    sample_format_of,
)

__all__ = ["unpack", "pack", "float_to_int32", "int32_to_float",
           "convert_normalized", "transfer_samples", "transfer_samples_typed",
           "transfer_samples_linear"]

_INT_NP = {SampleFormat.INT16: ("i2", 16), SampleFormat.INT32: ("i4", 0)}
_FLT_NP = {SampleFormat.FLOAT: "f4", SampleFormat.DOUBLE: "f8"}


def _endian_char(big_endian: bool) -> str:
    return ">" if big_endian else "<"


def unpack(raw: np.ndarray, fmt: SampleFormat,
           big_endian: bool = False) -> np.ndarray:
    """A flat uint8 buffer -> the normalized values: MSB-aligned int32 for
    the integer formats, float32 / float64 for the float ones."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    e = _endian_char(big_endian)
    if fmt in _INT_NP:
        code, shift = _INT_NP[fmt]
        vals = raw.view(e + code).astype(np.int32)
        return vals << shift if shift else vals
    if fmt == SampleFormat.INT24:
        b = raw.reshape(-1, 3).astype(np.uint32)
        if big_endian:
            u = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
        else:
            u = (b[:, 2] << 24) | (b[:, 1] << 16) | (b[:, 0] << 8)
        return u.view(np.int32)
    if fmt in _FLT_NP:
        return raw.view(e + _FLT_NP[fmt]).copy()
    raise ValueError(f"cannot unpack format {fmt!r}")


def pack(vals: np.ndarray, fmt: SampleFormat,
         big_endian: bool = False) -> np.ndarray:
    """Normalized values -> a flat uint8 buffer."""
    e = _endian_char(big_endian)
    if fmt == SampleFormat.INT16:
        return np.frombuffer(
            (vals >> 16).astype(np.int16).astype(e + "i2").tobytes(), np.uint8)
    if fmt == SampleFormat.INT32:
        return np.frombuffer(vals.astype(np.int32).astype(e + "i4").tobytes(),
                             np.uint8)
    if fmt == SampleFormat.INT24:
        u = vals.astype(np.int32, copy=False).view(np.uint32)
        out = np.empty((u.size, 3), np.uint8)
        order = (0, 1, 2) if big_endian else (2, 1, 0)
        for col, shift in zip(order, (24, 16, 8)):
            out[:, col] = (u >> shift) & 0xFF
        return out.reshape(-1)
    if fmt in _FLT_NP:
        return np.frombuffer(vals.astype(e + _FLT_NP[fmt]).tobytes(), np.uint8)
    raise ValueError(f"cannot pack format {fmt!r}")


def float_to_int32(x: np.ndarray) -> np.ndarray:
    """float -> normalized int32: scale by 2^31, clamp in float64,
    truncate toward zero."""
    d = np.clip(np.asarray(x, np.float64) * 2147483648.0, -2147483648.0,
                2147483647.0)
    return np.trunc(d).astype(np.int64).astype(np.int32)


def int32_to_float(x: np.ndarray, double: bool = False) -> np.ndarray:
    """Normalized int32 -> float32 (``float(i) * 2^-31`` in float32) or,
    with ``double``, float64."""
    if double:
        return np.asarray(x, np.float64) * np.float64(2.0**-31)
    return (np.asarray(x).astype(np.float32)
            * np.float32(2.0**-31)).astype(np.float32)


def convert_normalized(x: np.ndarray, src_fmt: SampleFormat,
                       dst_fmt: SampleFormat, ditherer: Ditherer | None = None,
                       channels: np.ndarray | None = None) -> np.ndarray:
    """Convert between normalized representations; ``channels`` gives the
    ditherer each sample's channel index."""
    src_int = is_sample_integer(src_fmt)
    if is_sample_integer(dst_fmt):
        v = np.asarray(x, np.int32) if src_int else float_to_int32(x)
        nbytes_dst = get_bytes_per_sample(dst_fmt)
        if ditherer is not None and nbytes_dst < get_bytes_per_sample(src_fmt):
            v = ditherer.dither_block(v, (4 - nbytes_dst) * 8, channels)
        # zero the bits the narrowing write drops, so the normalized value
        # is exact in the target width
        if dst_fmt == SampleFormat.INT16:
            v = (v >> 16) << 16
        elif dst_fmt == SampleFormat.INT24:
            v = (v >> 8) << 8
        return v
    if src_int:
        return int32_to_float(x, double=(dst_fmt == SampleFormat.DOUBLE))
    return np.asarray(x, np.float64 if dst_fmt == SampleFormat.DOUBLE
                      else np.float32)


def transfer_samples(
    src: np.ndarray,
    src_fmt: SampleFormat,
    src_be: bool,
    src_channel: int,
    src_channels: int,
    dst: np.ndarray,
    dst_fmt: SampleFormat,
    dst_be: bool,
    dst_channel: int,
    dst_channels: int,
    nchannels: int,
    nframes: int,
    ditherer: Ditherer | None = None,
) -> bool:
    """Copy, convert and (de)interleave a rectangle of frames between two
    flat uint8 buffers of interleaved frames; False if the clamped
    rectangle is empty.  ``src`` and ``dst`` may overlap: the source
    rectangle is read whole before anything is written."""
    ok, src_channel, dst_channel, nchannels, nframes = \
        block_transfer_sanity_checks(
            src_channel, src_channels, dst_channel, dst_channels, nchannels,
            nframes, allow_single_channel=ditherer is None)
    if not ok:
        return False
    sbytes = get_bytes_per_sample(src_fmt)
    dbytes = get_bytes_per_sample(dst_fmt)
    src = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
    dst = dst.view(np.uint8).reshape(-1)

    if ditherer is None and native.transfer_rect(
            src, src_fmt, src_be, src_channel, src_channels,
            dst, dst_fmt, dst_be, dst_channel, dst_channels,
            nchannels, nframes):
        return True

    col = np.arange(nchannels * sbytes) + src_channel * sbytes
    row = np.arange(nframes)[:, None] * (src_channels * sbytes)
    rect = src[row + col[None, :]].reshape(-1)
    vals = unpack(rect, src_fmt, src_be)
    ch = None if ditherer is None else np.tile(np.arange(nchannels), nframes)
    vals = convert_normalized(vals, src_fmt, dst_fmt, ditherer, channels=ch)
    out_bytes = pack(vals, dst_fmt, dst_be)
    dcol = np.arange(nchannels * dbytes) + dst_channel * dbytes
    drow = np.arange(nframes)[:, None] * (dst_channels * dbytes)
    dst[drow + dcol[None, :]] = out_bytes.reshape(nframes, -1)
    return True


def transfer_samples_typed(src: np.ndarray, src_channel: int, dst: np.ndarray,
                           dst_channel: int, nchannels: int, nframes: int,
                           ditherer: Ditherer | None = None) -> bool:
    """:func:`transfer_samples` between ``[frames, channels]`` arrays of
    sample dtypes, formats and byte orders read from the dtypes."""
    sfmt = sample_format_of(src.dtype)
    dfmt = sample_format_of(dst.dtype)
    if SampleFormat.UNKNOWN in (sfmt, dfmt):
        raise TypeError(f"unsupported sample dtypes {src.dtype}/{dst.dtype}")
    return transfer_samples(
        np.ascontiguousarray(src).view(np.uint8).reshape(-1), sfmt,
        src.dtype.byteorder == ">", src_channel, src.shape[1],
        dst.view(np.uint8).reshape(-1), dfmt, dst.dtype.byteorder == ">",
        dst_channel, dst.shape[1], nchannels, nframes, ditherer)


def transfer_samples_linear(src: np.ndarray, src_fmt: SampleFormat,
                            src_be: bool, dst: np.ndarray,
                            dst_fmt: SampleFormat, dst_be: bool,
                            nsamples: int,
                            ditherer: Ditherer | None = None) -> bool:
    """:func:`transfer_samples` of ``nsamples`` contiguous samples."""
    return transfer_samples(src, src_fmt, src_be, 0, 1, dst, dst_fmt, dst_be,
                            0, 1, 1, nsamples, ditherer)
