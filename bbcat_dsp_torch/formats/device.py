"""Sample conversions on the device, over ``[..., channels, time]`` tensors.

The counterpart of the JAX package's ``formats/device.py``, with the same
arithmetic: scaling by a power of two is exact, the clamp runs in float32
and the cast truncates, and narrowing to 16 or 24 bits clears the low bits
of the MSB-aligned int32 (a floor, as the reference's arithmetic shifts),
so both packages give the same bits on the same input.  Byte-packed
formats never reach the device: they are unpacked on the host
(:mod:`~bbcat_dsp_torch.formats.host`).
"""

from __future__ import annotations

import torch

from .sample_format import SampleFormat, is_sample_integer

__all__ = ["float_to_int32", "int32_to_float", "quantize", "convert",
           "transfer_window", "interleave", "deinterleave"]

_SCALE_UP = 2147483648.0  # 2^31
_SCALE_DOWN = 2.0 ** -31
# the largest float32 below 2^31: clamping to it keeps the cast in int32
_MAX_F32_INT = 2147483520.0
_DROPPED_BITS = {SampleFormat.INT16: 16, SampleFormat.INT24: 8,
                 SampleFormat.INT32: 0}


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> MSB-aligned int32: scale by 2^31, saturate, truncate."""
    d = torch.clamp(x.float() * _SCALE_UP, -_SCALE_UP, _MAX_F32_INT)
    return torch.trunc(d).to(torch.int32)


def int32_to_float(x: torch.Tensor) -> torch.Tensor:
    """MSB-aligned int32 -> float32: scale by 2^-31."""
    return x.float() * _SCALE_DOWN


def _narrow(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Clear the low ``bits`` of int32 ``v``: ``(v >> bits) << bits``."""
    return torch.bitwise_and(v, -(1 << bits)) if bits else v


def quantize(x: torch.Tensor, fmt: SampleFormat,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Round float32 ``x`` onto an integer format's grid and back: the
    precision a packed write of ``fmt`` keeps.

    With a ``generator`` (on ``x``'s device), TPDF dither is added to the
    32-bit register before the low bits are cleared: two uniform integers
    over one LSB of the target, less half an LSB, so the floor is
    unbiased, after a clamp that keeps the sum inside int32.  The JAX
    package draws the same distribution from ``jax.random``, so only the
    undithered result matches it bit for bit."""
    if fmt not in _DROPPED_BITS:
        raise ValueError(f"quantize expects an integer format, got {fmt!r}")
    bits = _DROPPED_BITS[fmt]
    v = float_to_int32(x)
    if generator is not None and bits > 0:
        lsb = 1 << bits
        r = torch.randint(0, lsb, x.shape, generator=generator,
                          dtype=torch.int32, device=x.device)
        r = r + torch.randint(0, lsb, x.shape, generator=generator,
                              dtype=torch.int32, device=x.device)
        v = torch.clamp(v, -(2**31) + 2 * lsb, 2**31 - 1 - 2 * lsb)
        v = v + (r - (lsb >> 1))
    return int32_to_float(_narrow(v, bits))


def convert(x: torch.Tensor, src_fmt: SampleFormat,
            dst_fmt: SampleFormat) -> torch.Tensor:
    """Convert a normalized tensor between format domains."""
    src_int = is_sample_integer(src_fmt)
    dst_int = is_sample_integer(dst_fmt)
    if src_int and not dst_int:
        return int32_to_float(x)
    if dst_int:
        v = x if src_int else float_to_int32(x)
        return _narrow(v, _DROPPED_BITS[SampleFormat(dst_fmt)])
    return x.float()


def transfer_window(src: torch.Tensor, dst: torch.Tensor, src_channel: int = 0,
                    dst_channel: int = 0, nchannels: int | None = None,
                    src_fmt: SampleFormat = SampleFormat.FLOAT,
                    dst_fmt: SampleFormat = SampleFormat.FLOAT) -> torch.Tensor:
    """``dst`` with ``nchannels`` channels of ``src`` from ``src_channel``
    converted into it from ``dst_channel``, over the time both hold; a new
    tensor, ``dst`` is left as it was."""
    room = min(src.shape[-2] - src_channel, dst.shape[-2] - dst_channel)
    nchannels = room if nchannels is None else min(nchannels, room)
    if nchannels <= 0:
        return dst
    nt = min(src.shape[-1], dst.shape[-1])
    block = convert(src[..., src_channel:src_channel + nchannels, :nt],
                    src_fmt, dst_fmt)
    out = dst.clone()
    out[..., dst_channel:dst_channel + nchannels, :nt] = block.to(dst.dtype)
    return out


def interleave(x: torch.Tensor) -> torch.Tensor:
    """``[channels, time]`` -> interleaved ``[time, channels]``."""
    return x.transpose(-1, -2)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """Interleaved ``[time, channels]`` -> ``[channels, time]``."""
    return x.transpose(-1, -2)
