"""Fused head of the two-level convolver (K1).

``fused_head_cuda`` launches ``csrc/fused_head.cu`` (the port of
``fused_head_pallas`` in the JAX package's ``ops/pallas/fused_head.py``), which
carries its own FFTs, in one of two schedules that
:func:`fused_head_schedule` picks from the shape and the card: the
resident one, a launch with one CTA a channel that keeps the channel's
filter and its last windows in shared memory, where the channels fill the
SMs; else the windowed one, two launches on the stream (every block's
window into a scratch, then the MAC and the inverses).  A call counts as
one launch of the kernel either way; the trace's kernel names
(``resident_kernel`` against ``windows_kernel`` and
``mac_inverse_kernel``) tell the schedules apart.  ``fused_head_plain``
is its PyTorch version, the unfused ``_head_spectra -> MAC ->
irfft_tail_planes`` composition of ``adjoint.xla_fused_head``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...convolve.fft import (
    half_window_signs,
    irfft_tail_planes,
    rfft_half_planes,
)
from . import _build
from .spectral_fir import cplane_mac

__all__ = ["fused_head_plain", "fused_head_cuda", "fused_head_cuda_as",
           "fused_head_schedule", "SCHEDULES"]

SCHEDULES = ("windowed", "resident")


_TWIDDLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def _twiddles(B: int, device: torch.device) -> torch.Tensor:
    """The kernel's ``[2B, 2]`` float32 table ``exp(-2 pi i m / 2B)`` on
    ``device``, computed in float64 once per block size and card."""
    key = (B, device)
    if key not in _TWIDDLES:
        ang = -np.pi * np.arange(2 * B) / B
        tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
        _TWIDDLES[key] = torch.from_numpy(tw).to(device)
    return _TWIDDLES[key]


def _head_spectra(prev_xt: torch.Tensor, x: torch.Tensor, B: int,
                  ratio: int):
    """Window spectra of ``ratio`` consecutive blocks of ``x [C, ratio*B]``
    by the half-window shift theorem: ``(X [2, ratio, C, F],
    new_prev_xt [2, C, F])``."""
    C = x.shape[0]
    xb = x.reshape(C, ratio, B).transpose(0, 1)          # [ratio, C, B]
    xt = rfft_half_planes(xb, 2 * B)                     # [2, ratio, C, F]
    ext = torch.cat([prev_xt[:, None], xt], dim=1)
    s = half_window_signs(2 * B, x.device)
    return ext[:, :-1] + s * ext[:, 1:], xt[:, -1].contiguous()


def fused_head_plain(x: torch.Tensor, xcarry: torch.Tensor,
                     prev: torch.Tensor, H: torch.Tensor, block: int):
    """Head over all ``R = T // block`` small blocks of ``x [C, T]``:
    ``(y [C, T], xcarry' [2, P, C, F], prev' [2, C, F])``."""
    _build.count_plain("fused_head")
    C, T = x.shape
    R = T // block
    P = H.shape[1]
    Xnew, prev_xt = _head_spectra(prev, x, block, R)
    xext = torch.cat([xcarry, Xnew], dim=1)              # [2, P+R, C, F]
    acc = cplane_mac(xext, H, R)
    y = irfft_tail_planes(acc, 2 * block)                # [R, C, B]
    return (y.transpose(0, 1).reshape(C, T), xext[:, -P:].contiguous(),
            prev_xt)


def resident_tile(B: int) -> int:
    """Output blocks a tile of the resident schedule: ``resident_tile`` of
    ``csrc/fused_head.cu``."""
    return 2 if B > 512 else 8


def _stage_entries(B: int) -> int:
    """Twiddles of the register FFT's stages after the first (8 points a
    thread): ``(radix - 1) * ns`` for each stage that finds ``ns``
    points combined."""
    n, ns = 0, 8
    while ns < B:
        n += (min(8, B // ns) - 1) * ns
        ns *= 8
    return n


def resident_smem_bytes(P: int, B: int) -> int:
    """Shared memory of the resident schedule's CTA (``resident_smem`` of
    ``csrc/fused_head.cu``, which the launch asks for): the stages'
    twiddles, the filter, the ring of ``P + 2 tile - 1`` windows (the tile
    the MAC reads and the next one, which the producer writes meanwhile)
    and the tile's spectra."""
    return (_stage_entries(B)
            + (2 * P + 3 * resident_tile(B) - 1) * (B + 1)) * 8


def fused_head_schedule(C: int, P: int, B: int, R: int, smem_bytes: int,
                        sms: int) -> str:
    """The schedule K1 runs in for C channels, P partitions, block B and R
    blocks on a card of ``sms`` SMs whose CTAs may opt into ``smem_bytes``
    of shared memory: resident where the channels fill the SMs, R fills its
    tile and a channel fits in shared memory, else windowed.

    On an H100 the resident schedule is the faster there at every shape
    measured (and at R = 2 and 4 from 132 channels on, left to the windowed
    one); below the SM count it is the faster from 64 channels at R <= 112,
    and the slower where a channel's blocks outgrow that (64 channels at
    R = 448, 16 at R = 2000), so the line stays at the SM count;
    ``scripts/kernel_times.py --only K1`` sweeps both."""
    resident = (C >= sms and R >= resident_tile(B)
                and resident_smem_bytes(P, B) <= smem_bytes)
    return SCHEDULES[resident]


_CARD_LIMITS: dict[torch.device, tuple[int, int]] = {}


def _card_limits(device: torch.device) -> tuple[int, int]:
    """``(smem_bytes, sms)`` of the card ``device``, the arguments
    :func:`fused_head_schedule` takes from it: the shared memory a CTA may
    opt into and the SM count, read once per card."""
    if device not in _CARD_LIMITS:
        props = torch.cuda.get_device_properties(device)
        _CARD_LIMITS[device] = (props.shared_memory_per_block_optin,
                                props.multi_processor_count)
    return _CARD_LIMITS[device]


def _checked(x, xcarry, prev, H, block):
    """Check the operands; ``(C, P, R, device)``."""
    B = block
    if not (32 <= B <= 1024 and B & (B - 1) == 0):
        raise ValueError(f"fused_head serves power-of-two blocks 32..1024, "
                         f"got {B}")
    if x.dim() != 2 or H.dim() != 4:
        raise ValueError("expected x [C, T] and H [2, P, C, F]")
    C, T = x.shape
    P, F = H.shape[1], B + 1
    if T % B or T == 0:
        raise ValueError(f"x length {T} is not a positive multiple of {B}")
    _build.require(x, "x", (C, T))
    _build.require(xcarry, "xcarry", (2, P, C, F))
    _build.require(prev, "prev", (2, C, F))
    _build.require(H, "H", (2, P, C, F))
    dev = _build.require_cuda(x=x, xcarry=xcarry, prev=prev, H=H)
    if x.data_ptr() % 8:
        raise ValueError("x: the kernel reads sample pairs; base pointer "
                         "must be 8-byte aligned")
    return C, P, T // B, dev


def _launch(schedule, x, xcarry, prev, H, block, C, P, R, dev):
    """One call of the kernel in ``schedule``.  A resident launch whose CTA
    does not fit the card fails in the library and raises here."""
    B, F = block, block + 1
    y = torch.empty_like(x)
    xcarry_out = torch.empty_like(xcarry)
    prev_out = torch.empty_like(prev)
    # the windowed schedule's windows, behind the carried ones, as complex
    # pairs; the resident one keeps them in shared memory
    win = (torch.empty((C, P + R, F, 2), dtype=torch.float32, device=dev)
           if schedule == "windowed" else None)
    with torch.cuda.device(dev):
        code = _build.library().bbcat_fused_head(
            x.data_ptr(), xcarry.data_ptr(), prev.data_ptr(), H.data_ptr(),
            _twiddles(B, dev).data_ptr(), y.data_ptr(),
            xcarry_out.data_ptr(), prev_out.data_ptr(),
            None if win is None else win.data_ptr(), C, P, B, R,
            SCHEDULES.index(schedule), _build.stream_of(x))
    _build.check(code, "fused_head")
    _build.LAUNCHES["fused_head"] += 1
    return y, xcarry_out, prev_out


def fused_head_cuda(x: torch.Tensor, xcarry: torch.Tensor,
                    prev: torch.Tensor, H: torch.Tensor, block: int):
    """Launch the K1 kernel; same contract as :func:`fused_head_plain`.
    Serves a power-of-two ``block`` from 32 to 1024 and any C, P, R, in the
    schedule :func:`fused_head_schedule` picks for the shape and the
    card."""
    C, P, R, dev = _checked(x, xcarry, prev, H, block)
    schedule = fused_head_schedule(C, P, block, R, *_card_limits(dev))
    return _launch(schedule, x, xcarry, prev, H, block, C, P, R, dev)


def fused_head_cuda_as(schedule: str, x: torch.Tensor, xcarry: torch.Tensor,
                       prev: torch.Tensor, H: torch.Tensor, block: int):
    """The K1 kernel in the named schedule of :data:`SCHEDULES`, whatever
    the shape: for timing and checking the two apart.  The
    port's paths call :func:`fused_head_cuda`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of {SCHEDULES}")
    return _launch(schedule, x, xcarry, prev, H, block,
                   *_checked(x, xcarry, prev, H, block))
