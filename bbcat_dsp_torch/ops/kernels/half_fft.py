"""Half-window transforms of the tail: rfft_half (K3) and irfft_tail (K4).

``rfft_half_cuda`` and ``irfft_tail_cuda`` launch ``csrc/half_fft.cu``,
which carries its own FFT: the port of ``perm_rfft_half_pallas`` and
``perm_irfft_tail_pallas`` in the JAX package's ``ops/pallas/perm_fft.py``,
in the standard (natural) bin order instead of the TPU's permuted one.
``rfft_half_plain`` and ``irfft_tail_plain`` are their PyTorch versions,
:func:`~bbcat_dsp_torch.convolve.fft.rfft_half_planes` and
:func:`~bbcat_dsp_torch.convolve.fft.irfft_tail_planes`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...convolve.fft import irfft_tail_planes, rfft_half_planes
from . import _build

__all__ = ["rfft_half_plain", "rfft_half_cuda", "irfft_tail_plain",
           "irfft_tail_cuda", "HALF_MIN", "HALF_MAX"]

# the half-window sizes h = n/2 the kernels serve (powers of two): those
# csrc/half_fft.cu instantiates
HALF_MIN, HALF_MAX = 32, 8192

_TWIDDLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def _points(h: int) -> int:
    """Points of a transform of half size ``h`` that one thread holds:
    ``kPoints`` of ``csrc/half_fft.cu``."""
    return 16 if h >= 1024 else 8


def _stages(h: int):
    """``(ns, radix)`` of each FFT stage: radix ``_points(h)`` while that
    many points remain to be combined, the rest in the last stage."""
    ns = 1
    while ns < h:
        r = min(_points(h), h // ns)
        yield ns, r
        ns *= r


def _twiddle_table(n: int) -> np.ndarray:
    """The kernels' ``[..., 2]`` float32 twiddle table for half size
    ``h = n/2``, computed in float64: for each stage after the first a
    table ``exp(-2 pi i q k / (ns r))`` at ``(q - 1) ns + k``, ``q = 1 ..
    r - 1``, ``k < ns``, one behind the other (``StageTables`` of
    ``csrc/fft_common.cuh``), then ``exp(-2 pi i k / n)`` for ``k = 0 ..
    h``, the real transform's."""
    h = n // 2
    turns = [np.outer(np.arange(1, r), np.arange(ns)).ravel() / (ns * r)
             for ns, r in _stages(h) if ns > 1]
    ang = -2.0 * np.pi * np.concatenate(turns + [np.arange(h + 1) / n])
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def _check_plan(h: int, table_len: int) -> None:
    """Hold this module's table layout for half size ``h`` against the
    one ``csrc/half_fft.cu`` reads: the table has two owners, and a kernel
    that reads another layout than the host wrote computes noise."""
    points, nstages, length = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    radices = (ctypes.c_int * 16)()
    code = _build.library().bbcat_half_fft_plan(
        h, ctypes.byref(points), radices, len(radices),
        ctypes.byref(nstages), ctypes.byref(length))
    _build.check(code, "half_fft_plan")
    theirs = (points.value, list(radices[:nstages.value]), length.value)
    mine = (_points(h), [r for _, r in _stages(h)], table_len)
    if theirs != mine:
        raise RuntimeError(
            f"twiddle table for h = {h}: the kernels read (points, radices, "
            f"entries) = {theirs}, this module lays out {mine}; change "
            "kPoints in csrc/half_fft.cu and _points here together")


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """:func:`_twiddle_table` on ``device``, made once per size and card,
    after its layout has been held against the kernels'."""
    key = (n, device)
    if key not in _TWIDDLES:
        table = _twiddle_table(n)
        _check_plan(n // 2, table.shape[0])
        _TWIDDLES[key] = torch.from_numpy(table).to(device)
    return _TWIDDLES[key]


def _half(n: int) -> int:
    h = n // 2
    if n != 2 * h or not (HALF_MIN <= h <= HALF_MAX and h & (h - 1) == 0):
        raise ValueError(f"the tail transforms serve power-of-two FFT sizes "
                         f"{2 * HALF_MIN}..{2 * HALF_MAX}, got {n}")
    return h


def rfft_half_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n/2]`` -> ``[2, ..., n/2 + 1]``, the half-window spectrum."""
    _build.count_plain("rfft_half")
    return rfft_half_planes(x, n)


def irfft_tail_plain(planes: torch.Tensor, n: int) -> torch.Tensor:
    """``[2, ..., n/2 + 1]`` -> ``[..., n/2]``, the inverse's last half."""
    _build.count_plain("irfft_tail")
    return irfft_tail_planes(planes, n)


def rfft_half_cuda(x: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the K3 kernel; same contract as :func:`rfft_half_plain`."""
    h = _half(n)
    if x.dim() < 1 or x.shape[-1] != h:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [..., {h}]")
    lead = tuple(x.shape[:-1])
    M = math.prod(lead)
    _build.require(x, "x", tuple(x.shape))
    dev = _build.require_cuda(x=x)
    if M == 0:
        raise ValueError("x: no rows to transform")
    if x.data_ptr() % 8:
        raise ValueError("x: the kernel reads sample pairs; base pointer "
                         "must be 8-byte aligned")
    out = torch.empty((2, *lead, h + 1), dtype=torch.float32, device=dev)
    tw = _twiddles(n, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.bbcat_rfft_half(x.data_ptr(), tw.data_ptr(),
                                   out.data_ptr(), M, h, _build.stream_of(x))
    _build.check(code, "rfft_half")
    _build.LAUNCHES["rfft_half"] += 1
    return out


def irfft_tail_cuda(planes: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the K4 kernel; same contract as :func:`irfft_tail_plain`."""
    h = _half(n)
    if planes.dim() < 2 or planes.shape[0] != 2 or planes.shape[-1] != h + 1:
        raise ValueError(f"planes: shape {tuple(planes.shape)}, expected "
                         f"[2, ..., {h + 1}]")
    lead = tuple(planes.shape[1:-1])
    M = math.prod(lead)
    _build.require(planes, "planes", tuple(planes.shape))
    dev = _build.require_cuda(planes=planes)
    if M == 0:
        raise ValueError("planes: no rows to transform")
    y = torch.empty((*lead, h), dtype=torch.float32, device=dev)
    tw = _twiddles(n, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.bbcat_irfft_tail(planes.data_ptr(), tw.data_ptr(),
                                    y.data_ptr(), M, h,
                                    _build.stream_of(planes))
    _build.check(code, "irfft_tail")
    _build.LAUNCHES["irfft_tail"] += 1
    return y
