"""Spectral MACs: the xt-grouped tail MAC (K2) and the shared MAC contract.

``xt_grouped_mac_cuda`` launches ``csrc/xt_grouped_mac.cu`` (the port of
``xt_grouped_mac_pallas`` in the JAX package's
``ops/pallas/spectral_fir.py``);
``xt_grouped_mac_plain`` is its PyTorch version, following
``adjoint.xla_xt_grouped_mac`` in the standard layout.
"""

from __future__ import annotations

import torch

from ...convolve.fft import half_window_signs
from . import _build

__all__ = ["cplane_mac", "xt_grouped_mac_plain", "xt_grouped_mac_cuda",
           "XT_MAX_PARTS", "XT_UNROLLED_PARTS", "XT_VEC"]

# the most partitions whose per-thread shared columns (3P-1 complex values)
# fit 32 threads in a CTA's 227 KB (csrc/xt_grouped_mac.cu)
XT_MAX_PARTS = 303
# up to this many partitions the kernel runs from registers
# (``kUnrolledParts`` there), above it the general shared-memory kernel
XT_UNROLLED_PARTS = 16
# elements a thread of the register kernel owns where C F is a multiple of
# it and every plane is aligned to it, else one (``kVec`` there)
XT_VEC = 2


def cplane_mac(V: torch.Tensor, H: torch.Tensor, ratio: int) -> torch.Tensor:
    """``acc[i] = sum_p V[P+i-p] * H[p]`` over re/im planes:
    ``V [2, P+ratio, C, F]``, ``H [2, P, C, F]`` -> ``[2, ratio, C, F]``."""
    P = H.shape[1]
    acc_r = torch.zeros_like(V[0, :ratio])
    acc_i = torch.zeros_like(V[0, :ratio])
    for p in range(P):
        vr = V[0, P - p:P - p + ratio]
        vi = V[1, P - p:P - p + ratio]
        hr, hi = H[0, p], H[1, p]
        acc_r = acc_r + (vr * hr - vi * hi)
        acc_i = acc_i + (vr * hi + vi * hr)
    return torch.stack([acc_r, acc_i])


def xt_grouped_mac_plain(queue: torch.Tensor, xt: torch.Tensor,
                         H: torch.Tensor, slot0: int) -> torch.Tensor:
    """``t = [queue rolled by slot0 | xt]``, ``w[k] = t[k] + (-1)^f
    t[k+1]``, ``out[j] = sum_p w[P-1+j-p] * H[p]``; all ``[2, P, C, F]``."""
    _build.count_plain("xt_grouped_mac")
    P, F = H.shape[1], H.shape[-1]
    s = half_window_signs(2 * (F - 1), queue.device)
    tseq = torch.cat([torch.roll(queue, -slot0, dims=1), xt], dim=1)
    w = tseq[:, :-1] + s * tseq[:, 1:]                      # [2, 2P-1, C, F]
    ext = torch.cat([torch.zeros_like(w[:, :1]), w], dim=1)
    return cplane_mac(ext, H, P)


def xt_grouped_mac_cuda(queue: torch.Tensor, xt: torch.Tensor,
                        H: torch.Tensor, slot0: int) -> torch.Tensor:
    """Launch the K2 kernel; same contract as :func:`xt_grouped_mac_plain`."""
    if H.dim() != 4 or H.shape[0] != 2:
        raise ValueError(f"H: shape {tuple(H.shape)}, expected [2, P, C, F]")
    _, P, C, F = H.shape
    if P > XT_MAX_PARTS:
        raise ValueError(f"xt_grouped_mac serves P <= {XT_MAX_PARTS}, got {P}")
    for name, t in (("queue", queue), ("xt", xt), ("H", H)):
        _build.require(t, name, (2, P, C, F))
    dev = _build.require_cuda(queue=queue, xt=xt, H=H)
    out = torch.empty_like(H)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.bbcat_xt_grouped_mac(
            queue.data_ptr(), xt.data_ptr(), H.data_ptr(), out.data_ptr(),
            P, C, F, slot0 % P, _build.stream_of(H))
    _build.check(code, "xt_grouped_mac")
    _build.LAUNCHES["xt_grouped_mac"] += 1
    return out
