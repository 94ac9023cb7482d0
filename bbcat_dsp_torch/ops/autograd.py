"""Derivatives through the kernels: one ``torch.autograd.Function`` per
dispatch function of :mod:`~bbcat_dsp_torch.ops_hook`.

The counterpart of the JAX package's ``ops/pallas/adjoint.py``.  Every
kernel is linear in each group of its tensor operands: the transforms (K3,
K4) and the marshalling ops (K5, K6) are linear maps, the spectral MACs
(K1, K2, K2s, K7, K9) are bilinear, linear in the signal's spectra and
linear in the filter's.  So each Function is exact with no derivative rule of
its own:

* **forward**: the dispatch as it is without a derivative, the kernel on
  a CUDA tensor and its plain version on a CPU tensor;
* **backward**: ``torch.func.vjp`` of the kernel's plain version, as
  ``linear_vjp`` takes ``jax.vjp`` of the ``xla_*`` formulation.  The
  plain version runs once more on the saved inputs; those runs count in
  ``ADJOINT_CALLS``, not in ``PLAIN_CALLS``;
* **jvp**: the kernel itself applied to the tangents: ``f(dx)`` for a
  linear kernel, ``f(dA, B) + f(A, dB)`` for a bilinear one, the term of
  a group without a tangent left out.  K1's carry outputs do not depend
  on the filter and take the first term only.  The JAX package leaves
  forward mode through its kernels undefined (``jax.jvp`` raises there);
  here it runs on the kernels.

The Functions take the ``forward`` + ``setup_context`` form, so that
``torch.func`` transforms (``grad``, ``vjp``, ``jvp``) accept them.  A
dispatch goes through its Function only when :func:`needs_derivative`
says so; inference calls the kernel directly, with no Function on the
path.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from .kernels import _build
from .kernels.fused_head import fused_head_cuda, fused_head_plain
from .kernels.half_fft import (
    irfft_tail_cuda,
    irfft_tail_plain,
    rfft_half_cuda,
    rfft_half_plain,
)
from .kernels.marshal import (
    delayed_add_cuda,
    delayed_add_plain,
    gather_supers_cuda,
    gather_supers_plain,
)
from .kernels.spectral_fir import xt_grouped_mac_cuda, xt_grouped_mac_plain
from .kernels.spectral_mac import (
    head_mac_cuda,
    head_mac_plain,
    rotated_mac_cuda,
    rotated_mac_plain,
    xt_step_mac_cuda,
    xt_step_mac_plain,
)

__all__ = ["needs_derivative", "FusedHead", "XtGroupedMac", "RfftHalf",
           "IrfftTail", "GatherSupers", "DelayedAdd", "HeadMac",
           "RotatedMac", "XtStepMac"]


def needs_derivative(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` has to record a derivative: grad mode
    is on and one of them requires grad, or one carries a forward-mode
    tangent (``torch.autograd.forward_ad`` or ``torch.func.jvp``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return True
    return fwAD._current_level >= 0 and any(
        fwAD.unpack_dual(t).tangent is not None for t in tensors)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


_WRAPPED = torch._C._functorch.is_functorch_wrapped_tensor


def _ready(t: torch.Tensor) -> torch.Tensor:
    """An operand as a kernel takes it: contiguous and, on the card,
    16-byte aligned (K1 and K3 read pairs of samples).  A tangent may be an
    expanded zero or a view at any offset; a functorch wrapper holds no
    storage and is made ready once unwrapped."""
    t = t.contiguous()
    if t.is_cuda and not _WRAPPED(t) and t.data_ptr() % 16:
        t = t.clone()
    return t


def _function(name: str, cuda, plain, groups: tuple):
    """The Function of one kernel.  Its tensor operands come first, in
    ``groups``: a tuple of one group (the argument indices of a linear
    kernel) or of two (a bilinear kernel, the signal's group first).  The
    filter's group reaches the first output only (K1's carry outputs
    depend on the signal alone).  ``Function.run`` is the dispatch
    without a derivative."""
    ntensor = sum(map(len, groups))

    def run(*args):
        return (cuda if _on_cuda(args[0]) else plain)(*args)

    def forward(*args):
        return run(*map(_ready, args[:ntensor]), *args[ntensor:])

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:ntensor])
        ctx.save_for_forward(*inputs[:ntensor])
        ctx.statics = inputs[ntensor:]

    def backward(ctx, *cts):
        prims = ctx.saved_tensors
        want = [i for i in range(ntensor) if ctx.needs_input_grad[i]]

        def of_wanted(*ws):
            args = list(prims)
            for i, w in zip(want, ws):
                args[i] = w
            return plain(*args, *ctx.statics)

        with _build.adjoint():
            _, vjp = torch.func.vjp(of_wanted, *(prims[i] for i in want))
            grads = vjp(cts if len(cts) > 1 else cts[0])
        out = [None] * (ntensor + len(ctx.statics))
        for i, g in zip(want, grads):
            out[i] = g
        return tuple(out)

    def on_tangents(*args):
        # under torch.func.jvp the tangents and saved inputs are functorch
        # wrappers, which hold no storage for a kernel to read: the
        # Function's own apply unwraps them and wraps the result
        if any(_WRAPPED(a) for a in args[:ntensor]):
            return cls.apply(*args)
        return run(*args)

    def jvp(ctx, *tangents):
        prims = ctx.saved_tensors
        total = None
        for k, group in enumerate(groups):
            if all(tangents[i] is None for i in group):
                continue
            args = list(prims)
            for i in group:
                args[i] = (torch.zeros_like(prims[i]) if tangents[i] is None
                           else _ready(tangents[i]))
            term = on_tangents(*args, *ctx.statics)
            term = list(term) if isinstance(term, tuple) else [term]
            if k == 0:
                total = term
            elif total is None:
                total = [term[0]] + [torch.zeros_like(t) for t in term[1:]]
            else:
                total[0] = total[0] + term[0]
        return tuple(total) if len(total) > 1 else total[0]

    ns = {"__doc__": f"{name}: the kernel forward, the plain version's vjp "
                     "backward, the kernel on the tangents forward.",
          "forward": staticmethod(forward),
          "setup_context": staticmethod(setup_context),
          "backward": staticmethod(backward),
          "jvp": staticmethod(jvp),
          "run": staticmethod(run)}
    cls = type(name, (torch.autograd.Function,), ns)
    return cls


# K1: (x, xcarry, prev) | H; the carry outputs are the signal's alone
FusedHead = _function("FusedHead", fused_head_cuda, fused_head_plain,
                      ((0, 1, 2), (3,)))
# K2: (queue, xt) | H
XtGroupedMac = _function("XtGroupedMac", xt_grouped_mac_cuda,
                         xt_grouped_mac_plain, ((0, 1), (2,)))
RfftHalf = _function("RfftHalf", rfft_half_cuda, rfft_half_plain, ((0,),))
IrfftTail = _function("IrfftTail", irfft_tail_cuda, irfft_tail_plain, ((0,),))
GatherSupers = _function("GatherSupers", gather_supers_cuda,
                         gather_supers_plain, ((0,),))
# K6: linear in its three operands jointly
DelayedAdd = _function("DelayedAdd", delayed_add_cuda, delayed_add_plain,
                       ((0, 1, 2),))
# K7 (and K8): xext | H
HeadMac = _function("HeadMac", head_mac_cuda, head_mac_plain, ((0,), (1,)))
# K9: queue | H
RotatedMac = _function("RotatedMac", rotated_mac_cuda, rotated_mac_plain,
                       ((0,), (1,)))
# K2s: (queue, xt) | H; recording a derivative, it never retires a slot
XtStepMac = _function("XtStepMac", xt_step_mac_cuda, xt_step_mac_plain,
                      ((0, 1), (2,)))
