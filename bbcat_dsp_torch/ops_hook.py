"""One dispatch function per kernel, the counterpart of ``ops_pallas_hook``.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version; a tensor anywhere else raises.  There is
no gate and no fallback: the kernel serves every shape the engine gives
it, and a launch that fails raises.

:func:`counts` reads, and :func:`reset_counts` zeroes, the kernels' launch
counts and the plain versions' call counts, so a run can show which of
the two its main path went through.
"""

from __future__ import annotations

import torch

from .ops.kernels import _build
from .ops.kernels.fused_head import fused_head_cuda, fused_head_plain
from .ops.kernels.half_fft import (
    irfft_tail_cuda,
    irfft_tail_plain,
    rfft_half_cuda,
    rfft_half_plain,
)
from .ops.kernels.marshal import (
    delayed_add_cuda,
    delayed_add_plain,
    gather_supers_cuda,
    gather_supers_plain,
)
from .ops.kernels.spectral_fir import xt_grouped_mac_cuda, xt_grouped_mac_plain
from .ops.kernels.spectral_mac import (
    head_mac_cuda,
    head_mac_plain,
    rotated_mac_cuda,
    rotated_mac_plain,
)

__all__ = ["fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
           "gather_supers", "delayed_add", "head_mac", "rotated_mac",
           "counts", "reset_counts"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def fused_head(x, xcarry, prev, H, block: int):
    """K1: ``(y [C, T], xcarry', prev')`` for the head over ``x [C, T]``."""
    if _on_cuda(x):
        return fused_head_cuda(x, xcarry, prev, H, block)
    return fused_head_plain(x, xcarry, prev, H, block)


def rfft_half(x, n: int):
    """K3: half-window spectrum ``[2, ..., n/2 + 1]`` of ``x [..., n/2]``."""
    if _on_cuda(x):
        return rfft_half_cuda(x, n)
    return rfft_half_plain(x, n)


def irfft_tail(planes, n: int):
    """K4: the last ``n/2`` samples of the inverse of ``[2, ..., n/2 + 1]``."""
    if _on_cuda(planes):
        return irfft_tail_cuda(planes, n)
    return irfft_tail_plain(planes, n)


def xt_grouped_mac(queue, xt, H, slot0: int):
    """K2: the whole-group tail MAC ``[2, P, C, F]``."""
    if _on_cuda(H):
        return xt_grouped_mac_cuda(queue, xt, H, slot0)
    return xt_grouped_mac_plain(queue, xt, H, slot0)


def gather_supers(x, nsup: int):
    """K5: ``[C, T]`` -> ``[nsup, C, T // nsup]``."""
    if _on_cuda(x):
        return gather_supers_cuda(x, nsup)
    return gather_supers_plain(x, nsup)


def delayed_add(y_head, pending, out_tail):
    """K6: output assembly under the 2-slot pending schedule."""
    if _on_cuda(y_head):
        return delayed_add_cuda(y_head, pending, out_tail)
    return delayed_add_plain(y_head, pending, out_tail)


def head_mac(xext, H, ratio: int):
    """K7 (and K8): ``acc[i] = sum_p xext[P+i-p] * H[p]``, ``[2, ratio,
    C, F]``, from the first ``P + ratio`` slots of ``xext``."""
    if _on_cuda(xext):
        return head_mac_cuda(xext, H, ratio)
    return head_mac_plain(xext, H, ratio)


def rotated_mac(queue, H, slot: int):
    """K9: ``acc = sum_p queue[(slot - p) % P] * H[p]``, ``[2, C, F]``."""
    if _on_cuda(queue):
        return rotated_mac_cuda(queue, H, slot)
    return rotated_mac_plain(queue, H, slot)


def counts() -> dict:
    """``{"launches": {kernel: n}, "plain": {kernel: n}}``."""
    return {"launches": dict(_build.LAUNCHES),
            "plain": dict(_build.PLAIN_CALLS)}


def reset_counts() -> None:
    for d in (_build.LAUNCHES, _build.PLAIN_CALLS):
        for k in d:
            d[k] = 0
