"""Composed stream-processing models: the binaural renderer and the
mixdown pipeline."""

from .binaural import (
    BinauralRenderer,
    BinauralState,
    binaural_init,
    binaural_step,
)
from .pipeline import MixdownPipeline

__all__ = ["BinauralRenderer", "BinauralState", "binaural_init",
           "binaural_step", "MixdownPipeline"]
