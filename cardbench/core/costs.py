"""The table of peaks and the arithmetic of a least time.

Frozen from ``chip_smoke.py`` (``bound``, ``fft_flops``): each input read
and each output written once at the memory's rate, or the operations at
the float32 rate outside the tensor cores, whichever is longer.
"""

from __future__ import annotations

import math

__all__ = ["PEAKS", "bound_s", "fft_flops"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,
}


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least seconds the card could take, and what sets them."""
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = flops / PEAKS["f32_flops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fft_flops(rows: int, h: int) -> float:
    """One complex h-point FFT per row (5 h log2 h) and the packing of its
    h + 1 real-transform bins (~12 each)."""
    return rows * (5.0 * h * math.log2(h) + 12.0 * (h + 1))
