"""bbcat_dsp_torch: the PyTorch/CUDA port of the JAX package beside it.

The port serves, on an NVIDIA Hopper card and on the CPU:

- the two-level convolver
  (:class:`~bbcat_dsp_torch.convolve.NonUniformConvolver`: render, streaming
  by super-block or by small block, click-free IR exchange), the uniform
  :class:`~bbcat_dsp_torch.convolve.BlockConvolver` and the MIMO/HRTF
  :class:`~bbcat_dsp_torch.convolve.MatrixConvolver`;
- the offline overlap-save convolution
  (:func:`~bbcat_dsp_torch.convolve.offline_convolve`);
- biquad design, the IIR engines (modal for fixed coefficients, stage by
  stage or a whole cascade in its parallel form; the companion scans for
  coefficients that change from sample to sample), the live EQ on them
  (:class:`~bbcat_dsp_torch.filters.BiQuadFilterBank` with click-free
  retargets, ``BiQuadCascade``, ``BiQuadBlock``,
  :class:`~bbcat_dsp_torch.filters.FilterManager`), all-pass and comb
  filters, fractional delay reads and the resampler
  (:mod:`~bbcat_dsp_torch.filters`) over a ring
  (:mod:`~bbcat_dsp_torch.buffers`);
- BS.1770 loudness and true peak (:mod:`~bbcat_dsp_torch.loudness`);
- the binaural renderer, the EQ and delay pipeline, the mixdown pipeline
  and the Schroeder reverb (:mod:`~bbcat_dsp_torch.models`);
- state files that this package and the JAX package both read
  (:mod:`~bbcat_dsp_torch.utils.checkpoint`);
- sample formats, dither and WAV files on the host
  (:mod:`~bbcat_dsp_torch.formats`, :mod:`~bbcat_dsp_torch.tools`), SOFA
  HRTF files (:mod:`~bbcat_dsp_torch.sofa`) and two command-line tools on
  the card (``python -m bbcat_dsp_torch.tools.convolve_cli``,
  ``loudness_cli``);
- the small device-side ops: delay, FIFO and multilayer buffers
  (:mod:`~bbcat_dsp_torch.buffers`), gain ramps, mixing and 2-D
  convolution (:mod:`~bbcat_dsp_torch.ops`), running averages and
  histograms (:mod:`~bbcat_dsp_torch.analysis`);
- sharding over a ``torch.distributed`` world
  (:mod:`~bbcat_dsp_torch.parallel`): channel- and time-sharded renders
  with the overlap-save halo exchange, sharded loudness, the
  communication model, and local worlds of processes.

On the card the convolvers run nine CUDA kernels written for ``sm_90a``
(``csrc/``); on the CPU the kernels' plain PyTorch versions.  The port
imports PyTorch and never JAX; the JAX package stays the reference it is
tested against.
"""

__version__ = "0.1.0"

from . import (
    analysis,
    buffers,
    convolve,
    filters,
    formats,
    loudness,
    models,
    ops,
    ops_hook,
    parallel,
    sofa,
    tools,
)
from .convolve import (
    BlockConvolver,
    MatrixConvolver,
    NonUniformConvolver,
    NonUniformState,
    offline_convolve,
)
from .filters import BiQuadFilterBank, FilterManager
from .loudness import LoudnessMeter
from .models import (
    BinauralRenderer,
    EQDelayPipeline,
    MixdownPipeline,
    SchroederReverb,
)
from .register import loaded_versions, register
from .utils.checkpoint import load_state, save_state

register()

__all__ = ["analysis", "buffers", "convolve", "filters", "formats",
           "loudness", "models", "ops", "ops_hook", "parallel", "sofa",
           "tools",
           "register", "loaded_versions", "BlockConvolver", "MatrixConvolver",
           "NonUniformConvolver", "NonUniformState", "LoudnessMeter",
           "BinauralRenderer", "EQDelayPipeline", "MixdownPipeline",
           "SchroederReverb", "BiQuadFilterBank", "FilterManager",
           "offline_convolve", "load_state", "save_state"]
