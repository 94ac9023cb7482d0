"""bbcat_dsp_torch: the PyTorch/CUDA port of the JAX package beside it.

The port serves, on an NVIDIA Hopper card and on the CPU:

- the two-level convolver
  (:class:`~bbcat_dsp_torch.convolve.NonUniformConvolver`: render, streaming
  by super-block or by small block, click-free IR exchange), the uniform
  :class:`~bbcat_dsp_torch.convolve.BlockConvolver` and the MIMO/HRTF
  :class:`~bbcat_dsp_torch.convolve.MatrixConvolver`;
- biquad design and the modal IIR engine (:mod:`~bbcat_dsp_torch.filters`);
- BS.1770 loudness and true peak (:mod:`~bbcat_dsp_torch.loudness`);
- the binaural renderer and the mixdown pipeline
  (:mod:`~bbcat_dsp_torch.models`).

On the card the convolvers run eight CUDA kernels written for ``sm_90a``
(``csrc/``); on the CPU the kernels' plain PyTorch versions.  The port
imports PyTorch and never JAX; the JAX package stays the reference it is
tested against.
"""

from . import convolve, filters, formats, loudness, models, ops_hook
from .convolve import (
    BlockConvolver,
    MatrixConvolver,
    NonUniformConvolver,
    NonUniformState,
)
from .loudness import LoudnessMeter
from .models import BinauralRenderer, MixdownPipeline

__all__ = ["convolve", "filters", "formats", "loudness", "models", "ops_hook",
           "BlockConvolver", "MatrixConvolver", "NonUniformConvolver",
           "NonUniformState", "LoudnessMeter", "BinauralRenderer",
           "MixdownPipeline"]
