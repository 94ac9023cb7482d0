"""Partitioned convolution: the two-level engine, the uniform
BlockConvolver and the MatrixConvolver, each streaming with click-free IR
exchange."""

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
from .matrix import (
    MatrixConvolver,
    filter_from_planes,
    matrix_render,
    matrix_step,
    matrix_step_crossfade,
    partition_ir_matrix,
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
]
