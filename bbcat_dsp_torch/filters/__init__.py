"""Filters: biquad design on the host, the IIR engines (modal for fixed
coefficients, the companion scans for coefficients that change from sample
to sample), the filter bank, cascade and manager classes over them,
all-pass and comb filters, fractional delay reads and the resampler that
stands on them."""

from .allpass import (
    AllPassFilter,
    AllPassFilterChain,
    allpass_apply,
    comb_apply,
)
from .bank import (
    BankState,
    BiQuadBlock,
    BiQuadCascade,
    BiQuadFilterBank,
    bank_init,
    bank_process,
    bank_set_stage,
)

from .biquad import (
    FilterType,
    biquad_coeffs,
    biquad_response,
    cascade_response,
    design_bank,
    write_response,
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
    biquad_apply,
    biquad_ssm,
    cascade_apply,
    interp_trajectory,
    modal_apply,
    modal_from_df2t,
    modal_init,
    modal_params,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from .manager import FilterManager
from .resample import Resampler, resample

__all__ = [
    "AllPassFilter",
    "AllPassFilterChain",
    "allpass_apply",
    "comb_apply",
    "BankState",
    "BiQuadBlock",
    "BiQuadCascade",
    "BiQuadFilterBank",
    "bank_init",
    "bank_process",
    "bank_set_stage",
    "FilterManager",
    "biquad_apply",
    "biquad_ssm",
    "cascade_apply",
    "interp_trajectory",
    "modal_from_df2t",
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "cascade_response",
    "design_bank",
    "write_response",
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
