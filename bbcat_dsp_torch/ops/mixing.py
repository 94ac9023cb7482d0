"""Mixing: a rectangle of channels scaled and added, with an optional
click-free gain ramp.

The counterpart of the JAX package's ``ops/mixing.py`` over ``[C, T]``
tensors.  Both functions return a new tensor and leave ``dst`` as it was.
"""

from __future__ import annotations

import torch

from .interpolator import Interpolator, interp_ramp

__all__ = ["mix_samples", "mix_samples_ramped"]


def mix_samples(dst: torch.Tensor, src: torch.Tensor, mul=1.0,
                src_channel: int = 0, dst_channel: int = 0,
                nchannels: int | None = None) -> torch.Tensor:
    """``dst[dc:dc+n] + mul * src[sc:sc+n]`` over the time both hold.  A
    ``mul`` of 0 given as a number returns ``dst`` itself with nothing
    computed."""
    room = min(src.shape[0] - src_channel, dst.shape[0] - dst_channel)
    nchannels = max(0, room if nchannels is None else min(nchannels, room))
    if nchannels == 0 or (not isinstance(mul, torch.Tensor) and mul == 0):
        return dst
    T = min(src.shape[-1], dst.shape[-1])
    mul = torch.as_tensor(mul, dtype=dst.dtype, device=dst.device)
    out = dst.clone()
    out[dst_channel:dst_channel + nchannels, :T] += (
        mul * src[src_channel:src_channel + nchannels, :T].to(dst.dtype))
    return out


def mix_samples_ramped(dst: torch.Tensor, src: torch.Tensor,
                       interp: Interpolator, inc, src_channel: int = 0,
                       dst_channel: int = 0, nchannels: int | None = None):
    """Mix with a gain that ``interp`` ramps frame by frame over the
    channel window: ``(dst', advanced interpolator)``."""
    if nchannels is None:
        nchannels = min(src.shape[0] - src_channel, dst.shape[0] - dst_channel)
    T = min(src.shape[-1], dst.shape[-1])
    ramp, interp = interp_ramp(interp, inc, T)
    out = dst.clone()
    out[dst_channel:dst_channel + nchannels, :T] += (
        ramp * src[src_channel:src_channel + nchannels, :T].to(dst.dtype))
    return out, interp
