"""Composed stream-processing models: the binaural renderer, the EQ and
delay pipeline and the mixdown pipeline."""

from .binaural import (
    BinauralRenderer,
    BinauralState,
    binaural_init,
    binaural_step,
)
from .pipeline import EQDelayPipeline, EQDelayState, MixdownPipeline

__all__ = ["BinauralRenderer", "BinauralState", "binaural_init",
           "binaural_step", "EQDelayPipeline", "EQDelayState",
           "MixdownPipeline"]
