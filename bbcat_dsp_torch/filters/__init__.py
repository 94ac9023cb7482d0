"""Filters: biquad design on the host, the modal IIR engine, fractional
delay reads and the resampler that stands on them."""

from .biquad import (
    FilterType,
    biquad_coeffs,
    biquad_response,
    cascade_response,
    design_bank,
)
from .fractional import (
    ADDITIONAL_DELAY,
    FractionalDelayLine,
    additional_delay_required,
    fractional_read,
    fractional_read_stream,
)
from .iir import (
    ModalParams,
    ModalState,
    ParallelCascadeParams,
    ParallelCascadeState,
    modal_apply,
    modal_init,
    modal_params,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from .resample import Resampler, resample

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "cascade_response",
    "design_bank",
    "ADDITIONAL_DELAY",
    "FractionalDelayLine",
    "additional_delay_required",
    "fractional_read",
    "fractional_read_stream",
    "ModalParams",
    "ModalState",
    "ParallelCascadeParams",
    "ParallelCascadeState",
    "modal_apply",
    "modal_init",
    "modal_params",
    "parallel_cascade_apply",
    "parallel_cascade_params",
    "Resampler",
    "resample",
]
