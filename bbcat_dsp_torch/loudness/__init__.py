"""ITU-R BS.1770 loudness and true peak."""

from .itu1770 import (
    LoudnessMeter,
    MeterState,
    block_powers,
    default_channel_weights,
    integrated_loudness,
    k_weight,
    k_weight_params,
    k_weighting_coeffs,
)
from .truepeak import true_peak, true_peak_db

__all__ = [
    "LoudnessMeter",
    "MeterState",
    "block_powers",
    "default_channel_weights",
    "integrated_loudness",
    "k_weight",
    "k_weight_params",
    "k_weighting_coeffs",
    "true_peak",
    "true_peak_db",
]
