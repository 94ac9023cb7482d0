"""Partitioned convolution: the two-level engine's render path."""

from .block import ConvolverState, convolver_init, partition_ir
from .fft import (
    SpectralSpec,
    half_window_signs,
    irfft_tail_planes,
    rfft_half_planes,
    spectral_nbins,
)
from .nonuniform import (
    NonUniformConvolver,
    NonUniformState,
    nonuniform_render,
    nonuniform_render_looped,
)

__all__ = [
    "ConvolverState",
    "convolver_init",
    "partition_ir",
    "SpectralSpec",
    "half_window_signs",
    "irfft_tail_planes",
    "rfft_half_planes",
    "spectral_nbins",
    "NonUniformConvolver",
    "NonUniformState",
    "nonuniform_render",
    "nonuniform_render_looped",
]
