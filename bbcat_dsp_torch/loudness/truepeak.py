"""True-peak metering (BS.1770-4 Annex 2): the peak of a 4x oversampled
signal.

The counterpart of the JAX package's ``loudness/truepeak.py``: the same
48-tap interpolator (12 taps per phase, a Kaiser-windowed sinc), applied to
the 12 shifted views of the signal as one float32 product at full
precision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import full_f32

__all__ = ["true_peak", "true_peak_db"]

_OS = 4
_TAPS_PER_PHASE = 12


def _design() -> np.ndarray:
    """The 48-tap 4x interpolator, a Kaiser (beta 10) windowed sinc cut at
    the original Nyquist: ``[4, 12]`` phase-major taps, float64."""
    n = _OS * _TAPS_PER_PHASE
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(t / _OS) * np.kaiser(n, 10.0)
    h *= _OS / h.sum()  # unity DC gain per phase
    return h.reshape(_TAPS_PER_PHASE, _OS).T.copy()


_H = _design().astype(np.float32)


def true_peak(x: torch.Tensor) -> torch.Tensor:
    """Largest 4x-oversampled absolute value per channel of ``x [..., T]``
    (linear).  Only positions whose 12 taps lie inside the block are
    interpolated: zero padding would read the block's edges as steps."""
    taps = torch.from_numpy(_H).to(x.device)                  # [4, 12]
    shifted = x.unfold(-1, _TAPS_PER_PHASE, 1)                 # [..., n, 12]
    with full_f32():
        ups = torch.matmul(shifted, taps.T)                    # [..., n, 4]
    peak_os = ups.abs().amax(dim=(-1, -2))
    # the sample peak too: the interpolator can undershoot a peak that
    # falls on a sample
    return torch.maximum(peak_os, x.abs().amax(dim=-1))


def true_peak_db(x: torch.Tensor) -> torch.Tensor:
    """True peak in dBTP per channel."""
    return 20.0 * torch.log10(torch.clamp(true_peak(x), min=1e-30))
