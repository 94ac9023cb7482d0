"""The inputs: room IRs and signals, made on the device from the seed in
one call each, in float32, the type the engine serves.

Frozen here from the pattern of ``chip_smoke.py`` (decaying-noise IRs,
distinct noise signals), with the decay set by the configuration.
"""

from __future__ import annotations

import math

import torch

__all__ = ["room_irs", "noise"]


def room_irs(channels: int, taps: int, rt60_s: float, sample_rate: int,
             gen: torch.Generator, device) -> torch.Tensor:
    """``[channels, taps]`` float32: Gaussian noise under an exponential
    envelope that falls 60 dB in ``rt60_s``, each channel scaled to unit
    energy, so every output has about the input's level."""
    n = torch.arange(taps, device=device, dtype=torch.float32)
    env = torch.exp(n * (-math.log(1000.0) / (rt60_s * sample_rate)))
    ir = torch.randn((channels, taps), generator=gen, device=device) * env
    return ir / ir.norm(dim=1, keepdim=True)


def noise(shape, rms: float, gen: torch.Generator, device) -> torch.Tensor:
    """White Gaussian noise of ``shape`` at ``rms``, float32."""
    return torch.randn(shape, generator=gen, device=device).mul_(rms)
