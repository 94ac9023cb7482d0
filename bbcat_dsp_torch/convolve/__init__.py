"""Partitioned convolution: the two-level engine and the uniform
BlockConvolver, each streaming with click-free IR exchange."""

from .block import (
    BlockConvolver,
    ConvolverState,
    convolver_init,
    convolver_render,
    convolver_step,
    convolver_step_crossfade,
    partition_ir,
)
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
    "BlockConvolver",
    "ConvolverState",
    "convolver_init",
    "convolver_render",
    "convolver_step",
    "convolver_step_crossfade",
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
