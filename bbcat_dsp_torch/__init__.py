"""bbcat_dsp_torch: the PyTorch/CUDA port of the JAX package beside it.

The port serves the two-level convolver
(:class:`~bbcat_dsp_torch.convolve.NonUniformConvolver`: render, streaming
by super-block or by small block, click-free IR exchange) and the uniform
:class:`~bbcat_dsp_torch.convolve.BlockConvolver` on an NVIDIA Hopper card,
through eight CUDA kernels written for ``sm_90a`` (``csrc/``), and on the
CPU through the kernels' plain PyTorch versions.
It imports PyTorch and never JAX; the JAX package stays the reference it
is tested against.
"""

from . import convolve, ops_hook
from .convolve import BlockConvolver, NonUniformConvolver, NonUniformState

__all__ = ["convolve", "ops_hook", "BlockConvolver", "NonUniformConvolver",
           "NonUniformState"]
