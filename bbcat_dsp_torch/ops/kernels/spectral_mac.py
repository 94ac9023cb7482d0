"""Spectral MACs of the streaming engines: head_mac (K7/K8), rotated_mac
(K9) and xt_step_mac (K2s).

``head_mac_cuda`` and ``rotated_mac_cuda`` launch ``csrc/spectral_mac.cu``,
the port of ``head_mac_tiled_pallas`` and ``head_mac_pallas`` (one kernel at
any C) and of ``rotated_mac_pallas`` in the JAX package's ``ops/pallas/``.
``head_mac_plain`` is their PyTorch version, a counted call of
:func:`~bbcat_dsp_torch.ops.kernels.spectral_fir.cplane_mac` (which stays the
uncounted MAC inside the plain K1 and K2); ``rotated_mac_plain`` follows
``adjoint.xla_rotated_mac``.

K9 reads the spectral queue in the convolvers' storage type (float32,
bfloat16 or float16) and widens it to float32; each type's launches and
plain calls count under its own name (:data:`ROTATED_MAC_NAMES`).  Its
CUDA kernel splits the partitions over the rows of a CTA and adds the
rows' sums in a fixed order (:data:`ROTATED_MAC_SCHEDULE`), so its float32
sums take another order than the plain version's.

``xt_step_mac_cuda`` launches ``csrc/xt_step_mac.cu``, the two-level
engine's single tail super-step (no TPU kernel: the JAX package forms the
windows with XLA ops); ``xt_step_mac_plain`` is that composition, the
queue rolled to its oldest slot, the windows and K7's contract at one
output.  Like K9 it reads a queue of any of the three types; it counts
under one name.  Asked to, both retire the oldest slot in place, writing
the new half spectrum there.
"""

from __future__ import annotations

import torch

from ...convolve.fft import half_window_signs
from . import _build
from .spectral_fir import cplane_mac

__all__ = ["head_mac_plain", "head_mac_cuda", "rotated_mac_plain",
           "rotated_mac_cuda", "xt_step_mac_plain", "xt_step_mac_cuda",
           "ROTATED_MAC_NAMES", "ROTATED_MAC_SCHEDULE"]

# the queue's type -> K9's count name and the kernel's type code
ROTATED_MAC_NAMES = {torch.float32: "rotated_mac",
                     torch.bfloat16: "rotated_mac_bf16",
                     torch.float16: "rotated_mac_f16"}
_QTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the CUDA K9's schedule, as csrc/spectral_mac.cu's constants (in its
# order, which bbcat_rotated_mac_schedule reports): threads of a CTA along
# the bins, groups of partitions, partitions loaded ahead, bins a thread
# takes where C F is a multiple of it
ROTATED_MAC_SCHEDULE = {"lanes": 16, "split": 8, "ahead": 4, "vec": 4}


def head_mac_plain(xext: torch.Tensor, H: torch.Tensor,
                   ratio: int) -> torch.Tensor:
    """``acc[i] = sum_p xext[P+i-p] * H[p]``: ``xext [2, D, C, F]`` with
    ``D >= P + ratio`` (only the first ``P + ratio`` slots are read), ``H
    [2, P, C, F]`` -> ``[2, ratio, C, F]``."""
    _build.count_plain("head_mac")
    return cplane_mac(xext, H, ratio)


def rotated_mac_plain(queue: torch.Tensor, H: torch.Tensor,
                      slot: int) -> torch.Tensor:
    """``acc = sum_p queue[(slot - p) % P] * H[p]``: ``queue, H [2, P, C,
    F]`` -> ``[2, C, F]`` float32; a narrow queue is widened to float32
    first."""
    _build.count_plain(ROTATED_MAC_NAMES.get(queue.dtype, "rotated_mac"))
    P = H.shape[1]
    if queue.dtype in (torch.bfloat16, torch.float16):
        queue = queue.float()
    acc_r = torch.zeros_like(queue[0, 0])
    acc_i = torch.zeros_like(queue[0, 0])
    for p in range(P):
        k = (slot - p) % P
        qr, qi = queue[0, k], queue[1, k]
        hr, hi = H[0, p], H[1, p]
        acc_r = acc_r + (qr * hr - qi * hi)
        acc_i = acc_i + (qr * hi + qi * hr)
    return torch.stack([acc_r, acc_i])


def _planes_of(H: torch.Tensor):
    if H.dim() != 4 or H.shape[0] != 2 or 0 in H.shape:
        raise ValueError(f"H: shape {tuple(H.shape)}, expected [2, P, C, F]")
    return H.shape[1:]


def head_mac_cuda(xext: torch.Tensor, H: torch.Tensor,
                  ratio: int) -> torch.Tensor:
    """Launch the K7 kernel; same contract as :func:`head_mac_plain`.
    One launch over (bins, tiles of outputs) at any ``ratio`` up to 65535.
    The kernel takes the history as it is, deeper than ``P + ratio`` or
    not, so a caller that needs fewer outputs than its history holds
    passes the whole contiguous tensor, not a slice of it."""
    P, C, F = _planes_of(H)
    if xext.dim() != 4 or ratio < 1 or xext.shape[1] < P + ratio:
        raise ValueError(f"xext: shape {tuple(xext.shape)}, expected "
                         f"[2, >= {P + ratio}, {C}, {F}] for ratio {ratio}")
    D = xext.shape[1]
    _build.require(xext, "xext", (2, D, C, F))
    _build.require(H, "H", (2, P, C, F))
    dev = _build.require_cuda(xext=xext, H=H)
    out = torch.empty((2, ratio, C, F), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.bbcat_head_mac(xext.data_ptr(), H.data_ptr(),
                                  out.data_ptr(), P, D, ratio, C, F,
                                  _build.stream_of(H))
    _build.check(code, "head_mac")
    _build.LAUNCHES["head_mac"] += 1
    return out


def rotated_mac_cuda(queue: torch.Tensor, H: torch.Tensor,
                     slot: int) -> torch.Tensor:
    """Launch the K9 kernel; same contract as :func:`rotated_mac_plain`.
    The queue may be float32, bfloat16 or float16; H is float32."""
    P, C, F = _planes_of(H)
    _build.require(queue, "queue", (2, P, C, F), tuple(ROTATED_MAC_NAMES))
    _build.require(H, "H", (2, P, C, F))
    dev = _build.require_cuda(queue=queue, H=H)
    out = torch.empty((2, C, F), dtype=torch.float32, device=dev)
    lib = _build.library()
    name = ROTATED_MAC_NAMES[queue.dtype]
    with torch.cuda.device(dev):
        code = lib.bbcat_rotated_mac(queue.data_ptr(), H.data_ptr(),
                                     out.data_ptr(), P, C, F, slot % P,
                                     _QTYPE_CODES[queue.dtype],
                                     _build.stream_of(H))
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


def xt_step_mac_plain(queue: torch.Tensor, xt: torch.Tensor,
                      H: torch.Tensor, slot: int,
                      retire: bool = False) -> torch.Tensor:
    """``t = [queue rolled by slot | xt]`` widened to float32, ``w[k] =
    t[k] + (-1)^f t[k+1]``, ``out = sum_p w[P-1-p] * H[p]``: ``queue, H
    [2, P, C, F]``, ``xt [2, C, F]`` -> ``[2, C, F]`` float32.  With
    ``retire``, then ``queue[:, slot] = xt`` rounded to the queue's type,
    in place."""
    _build.count_plain("xt_step_mac")
    P, F = H.shape[1], H.shape[-1]
    slot %= P
    s = half_window_signs(2 * (F - 1), queue.device)
    tseq = torch.cat([torch.roll(queue, -slot, dims=1).float(),
                      xt[:, None]], dim=1)
    w = tseq[:, :-1] + s * tseq[:, 1:]                      # [2, P, C, F]
    # K7's contract at one output, behind one never-read slot
    out = cplane_mac(torch.cat([torch.zeros_like(w[:, :1]), w], dim=1),
                     H, 1)[:, 0]
    if retire:
        queue[:, slot] = xt.to(queue.dtype)
    return out


def xt_step_mac_cuda(queue: torch.Tensor, xt: torch.Tensor, H: torch.Tensor,
                     slot: int, retire: bool = False) -> torch.Tensor:
    """Launch the K2s kernel; same contract as :func:`xt_step_mac_plain`.
    The queue may be float32, bfloat16 or float16; xt and H are float32."""
    P, C, F = _planes_of(H)
    _build.require(queue, "queue", (2, P, C, F), tuple(ROTATED_MAC_NAMES))
    _build.require(xt, "xt", (2, C, F))
    _build.require(H, "H", (2, P, C, F))
    dev = _build.require_cuda(queue=queue, xt=xt, H=H)
    out = torch.empty((2, C, F), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.bbcat_xt_step_mac(queue.data_ptr(), xt.data_ptr(),
                                     H.data_ptr(), out.data_ptr(), P, C, F,
                                     slot % P, _QTYPE_CODES[queue.dtype],
                                     int(retire), _build.stream_of(H))
    _build.check(code, "xt_step_mac")
    _build.LAUNCHES["xt_step_mac"] += 1
    return out
