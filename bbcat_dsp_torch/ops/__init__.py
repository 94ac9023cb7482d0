"""Hand-written CUDA kernels and their plain PyTorch versions
(:mod:`~bbcat_dsp_torch.ops.kernels`), and the small device-side ops:
mixing, interpolation ramps and 2-D convolution."""

from .conv2d import convolve2d
from .interpolator import (
    ComplexInterpolator,
    Interpolator,
    complex_interp_ramp,
    complex_interpolator,
    interp_ramp,
    interpolator,
)
from .mixing import mix_samples, mix_samples_ramped

__all__ = ["ComplexInterpolator", "Interpolator", "complex_interp_ramp",
           "complex_interpolator", "interp_ramp", "interpolator",
           "mix_samples", "mix_samples_ramped", "convolve2d"]
