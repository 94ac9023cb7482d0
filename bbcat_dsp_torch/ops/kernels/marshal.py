"""Render-group marshalling: gather_supers (K5) and delayed_add (K6).

The ``*_cuda`` wrappers launch ``csrc/marshal.cu`` (the port of
``gather_supers_pallas`` and ``delayed_add_pallas`` in
the JAX package's ``ops/pallas/marshal.py``); the ``*_plain`` functions are
their PyTorch versions, following ``adjoint.xla_gather_supers`` and
``adjoint.xla_delayed_add``.  Both kernels are bit-identical to them.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["gather_supers_plain", "gather_supers_cuda", "delayed_add_plain",
           "delayed_add_cuda"]


def _split(T: int, nsup: int) -> int:
    if nsup < 1 or T % nsup:
        raise ValueError(f"T={T} does not split into {nsup} super-blocks")
    return T // nsup


def gather_supers_plain(x: torch.Tensor, nsup: int) -> torch.Tensor:
    """``x [C, T]`` -> ``[nsup, C, T // nsup]``."""
    _build.count_plain("gather_supers")
    C, T = x.shape
    return x.reshape(C, nsup, _split(T, nsup)).transpose(0, 1).contiguous()


def gather_supers_cuda(x: torch.Tensor, nsup: int) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [C, T]")
    C, T = x.shape
    B2 = _split(T, nsup)
    _build.require(x, "x", (C, T))
    _build.require_cuda(x=x)
    out = torch.empty((nsup, C, B2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.bbcat_gather_supers(x.data_ptr(), out.data_ptr(), C, nsup,
                                       B2, _build.stream_of(x))
    _build.check(code, "gather_supers")
    _build.LAUNCHES["gather_supers"] += 1
    return out


def delayed_add_plain(y_head: torch.Tensor, pending: torch.Tensor,
                      out_tail: torch.Tensor) -> torch.Tensor:
    """``y[:, j] = y_head[:, j] + (pending[j] if j < 2 else
    out_tail[j-2])`` over the ``Pt`` super-blocks ``j`` of ``y_head``."""
    _build.count_plain("delayed_add")
    C, T = y_head.shape
    Pt = out_tail.shape[0]
    delayed = torch.cat([pending, out_tail])[:Pt]
    return y_head + delayed.transpose(0, 1).reshape(C, T)


def delayed_add_cuda(y_head: torch.Tensor, pending: torch.Tensor,
                     out_tail: torch.Tensor) -> torch.Tensor:
    if y_head.dim() != 2 or out_tail.dim() != 3:
        raise ValueError("expected y_head [C, T] and out_tail [Pt, C, B2]")
    C, T = y_head.shape
    Pt = out_tail.shape[0]
    B2 = _split(T, Pt)
    _build.require(y_head, "y_head", (C, T))
    _build.require(pending, "pending", (2, C, B2))
    _build.require(out_tail, "out_tail", (Pt, C, B2))
    _build.require_cuda(y_head=y_head, pending=pending, out_tail=out_tail)
    y = torch.empty_like(y_head)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(y.device):
        code = lib.bbcat_delayed_add(
            y_head.data_ptr(), pending.data_ptr(), out_tail.data_ptr(),
            y.data_ptr(), C, Pt, B2, _build.stream_of(y))
    _build.check(code, "delayed_add")
    _build.LAUNCHES["delayed_add"] += 1
    return y
