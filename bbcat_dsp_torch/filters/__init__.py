"""Filters: biquad design on the host and the modal IIR engine."""

from .biquad import (
    FilterType,
    biquad_coeffs,
    biquad_response,
    cascade_response,
    design_bank,
)
from .iir import ModalParams, ModalState, modal_apply, modal_init, modal_params

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "cascade_response",
    "design_bank",
    "ModalParams",
    "ModalState",
    "modal_apply",
    "modal_init",
    "modal_params",
]
