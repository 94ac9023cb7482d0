"""Biquad coefficient design on the host, in float64.

The counterpart of the JAX package's ``filters/biquad.py`` and of the RBJ
design in its ``golden/biquad.py``, re-derived here because the port does
not import that package.  Design runs at parameter-change rate, so it stays
numpy float64 on the host; :func:`~bbcat_dsp_torch.filters.iir.modal_params`
takes the float64 rows to the device.
"""

from __future__ import annotations

import enum
import math

import numpy as np

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "design_bank",
    "cascade_response",
    "write_response",
]


class FilterType(enum.IntEnum):
    """Filter taxonomy, with the reference enum's integer values."""

    FLAT = 0
    LPF6 = 1
    HPF6 = 2
    LPF12 = 3
    HPF12 = 4
    BPF = 5
    NOTCH = 6
    PEQ = 7
    LSH = 8
    HSH = 9


def biquad_coeffs(ftype: FilterType, freq: float, fs: float,
                  gain: float = 0.0, bandwidth: float = 1.0) -> np.ndarray:
    """RBJ Audio-EQ-Cookbook coefficients, a0-normalised: ``[b0, b1, b2,
    a1, a2]`` float64 (with the non-cookbook 6/12 dB LPF/HPF variants)."""
    A = 10.0 ** (gain / 40.0)
    omega = 2.0 * math.pi * freq / fs
    sn = math.sin(omega)
    cs = math.cos(omega)
    alpha = sn * math.sinh(math.log(2.0) / 2.0 * bandwidth * omega / sn)
    beta = math.sqrt(A + A)

    t = FilterType(ftype)
    if t == FilterType.FLAT:
        b0, b1, b2, a0, a1, a2 = 1.0, 0.0, 0.0, 1.0, 0.0, 0.0
    elif t == FilterType.LPF6:
        b0, b1, b2, a0, a1, a2 = sn, 0.0, 0.0, 1.0 + sn, -1.0, 0.0
    elif t == FilterType.LPF12:
        b0, b1, b2 = sn * sn, 0.0, 0.0
        a0, a1, a2 = (1.0 + sn) ** 2, -2.0 * (1.0 + sn), 1.0
    elif t == FilterType.HPF6:
        b0, b1, b2, a0, a1, a2 = 1.0, -1.0, 0.0, 1.0, -(1.0 - sn), 0.0
    elif t == FilterType.HPF12:
        b0, b1, b2 = 1.0, -2.0, 1.0
        a0, a1, a2 = 1.0, -2.0 * (1.0 - sn), (1.0 - sn) ** 2
    elif t == FilterType.BPF:
        b0, b1, b2 = alpha, 0.0, -alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cs, 1.0 - alpha
    elif t == FilterType.NOTCH:
        b0, b1, b2 = 1.0, -2.0 * cs, 1.0
        a0, a1, a2 = 1.0 + alpha, -2.0 * cs, 1.0 - alpha
    elif t == FilterType.PEQ:
        b0, b1, b2 = 1.0 + alpha * A, -2.0 * cs, 1.0 - alpha * A
        a0, a1, a2 = 1.0 + alpha / A, -2.0 * cs, 1.0 - alpha / A
    elif t == FilterType.LSH:
        b0 = A * ((A + 1.0) - (A - 1.0) * cs + beta * sn)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cs)
        b2 = A * ((A + 1.0) - (A - 1.0) * cs - beta * sn)
        a0 = (A + 1.0) + (A - 1.0) * cs + beta * sn
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cs)
        a2 = (A + 1.0) + (A - 1.0) * cs - beta * sn
    else:  # HSH
        b0 = A * ((A + 1.0) + (A - 1.0) * cs + beta * sn)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cs)
        b2 = A * ((A + 1.0) + (A - 1.0) * cs - beta * sn)
        a0 = (A + 1.0) - (A - 1.0) * cs + beta * sn
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cs)
        a2 = (A + 1.0) - (A - 1.0) * cs - beta * sn

    n = 1.0 / a0
    return np.array([b0 * n, b1 * n, b2 * n, a1 * n, a2 * n], np.float64)


def biquad_response(coeffs, f, fs: float) -> np.ndarray:
    """Complex response at frequency/ies ``f``, with the reference's
    convention ``z1 = exp(+2 pi j f / fs)``."""
    b0, b1, b2, a1, a2 = np.asarray(coeffs, np.float64)
    z1 = np.exp(2j * np.pi * np.asarray(f, np.float64) / fs)
    z2 = z1 * z1
    return (b0 + b1 * z1 + b2 * z2) / (1.0 + a1 * z1 + a2 * z2)


def design_bank(specs) -> np.ndarray:
    """A stack of biquads ``[stages, 5]`` float64 from dicts with keys
    ``type`` (a :class:`FilterType` or its name), ``freq``, ``fs`` and
    optionally ``gain`` and ``bandwidth``, or from tuples ``(type, freq,
    fs[, gain[, bandwidth]])``."""
    rows = []
    for spec in specs:
        if isinstance(spec, dict):
            t = spec["type"]
            rows.append(biquad_coeffs(
                FilterType[t] if isinstance(t, str) else t, spec["freq"],
                spec["fs"], spec.get("gain", 0.0), spec.get("bandwidth", 1.0)))
        else:
            rows.append(biquad_coeffs(*spec))
    return np.stack(rows)


def cascade_response(coeffs, f, fs: float) -> np.ndarray:
    """Complex response of a cascade: the product of its stages'."""
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    h = np.ones_like(np.asarray(f, np.float64), dtype=np.complex128)
    for row in coeffs:
        h = h * biquad_response(row, f, fs)
    return h


def write_response(path, coeffs, fs: float, npoints: int = 1000,
                   fmin: float = 10.0) -> np.ndarray:
    """Write the magnitude response (dB) of a biquad or a cascade at
    ``npoints`` log-spaced frequencies from ``fmin`` to ``fs / 2`` to
    ``path``, one ``<freq_hz> <mag_db>`` line a point: the reference's
    debug dump (1000 points to ``coeffs.dat``).  The file is the JAX
    package's byte for byte.  Returns the frequency grid."""
    fmax = fs / 2.0
    f = fmin * (fmax / fmin) ** (np.arange(npoints) / (npoints - 1))
    mag = np.abs(cascade_response(coeffs, f, fs))
    db = 20.0 * np.log10(np.maximum(mag, 1e-30))
    with open(path, "w") as fh:
        for fi, di in zip(f, db):
            fh.write(f"{fi:.6f} {di:.6f}\n")
    return f
