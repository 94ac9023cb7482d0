"""Composed stream-processing models: the binaural renderer, the EQ and
delay pipeline, the mixdown pipeline and the Schroeder reverb."""

from .binaural import (
    BinauralRenderer,
    BinauralState,
    binaural_init,
    binaural_step,
)
from .pipeline import EQDelayPipeline, EQDelayState, MixdownPipeline
from .reverb import SchroederReverb

__all__ = ["BinauralRenderer", "BinauralState", "binaural_init",
           "binaural_step", "EQDelayPipeline", "EQDelayState",
           "MixdownPipeline", "SchroederReverb"]
