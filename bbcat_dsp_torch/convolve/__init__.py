"""Partitioned convolution: the two-level engine, the uniform
BlockConvolver and the MatrixConvolver, each streaming with click-free IR
exchange; and the offline overlap-save convolution."""

from .block import (
    BlockConvolver,
    ConvolverState,
    convolver_init,
    convolver_render,
    convolver_step,
    convolver_step_crossfade,
    ir_spectra,
    partition_ir,
)
from .fft import (
    SpectralSpec,
    cmul,
    half_window_signs,
    irfft_planes,
    irfft_tail_planes,
    rfft_half_planes,
    rfft_planes,
    spectral_nbins,
)
from .matrix import (
    MatrixConvolver,
    filter_from_planes,
    matrix_render,
    matrix_step,
    matrix_step_crossfade,
    partition_ir_matrix,
)
from .offline import offline_convolve
from .nonuniform import (
    NonUniformConvolver,
    NonUniformState,
    nonuniform_render,
    nonuniform_render_looped,
    nonuniform_spectra,
)

__all__ = [
    "BlockConvolver",
    "ConvolverState",
    "convolver_init",
    "convolver_render",
    "convolver_step",
    "convolver_step_crossfade",
    "partition_ir",
    "ir_spectra",
    "SpectralSpec",
    "cmul",
    "half_window_signs",
    "irfft_planes",
    "irfft_tail_planes",
    "rfft_half_planes",
    "rfft_planes",
    "spectral_nbins",
    "MatrixConvolver",
    "filter_from_planes",
    "matrix_render",
    "matrix_step",
    "matrix_step_crossfade",
    "partition_ir_matrix",
    "NonUniformConvolver",
    "NonUniformState",
    "nonuniform_render",
    "nonuniform_render_looped",
    "nonuniform_spectra",
    "offline_convolve",
]
