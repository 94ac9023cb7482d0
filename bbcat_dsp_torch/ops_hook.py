"""One dispatch function per kernel, the counterpart of ``ops_pallas_hook``.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version; a tensor anywhere else raises.  There is
no gate and no fallback: the kernel serves every shape the engine gives
it, and a launch that fails raises.

A call that has to record a derivative (grad mode on and an operand that
requires grad, or an operand with a forward-mode tangent) goes through the
kernel's ``torch.autograd.Function`` (:mod:`~bbcat_dsp_torch.ops.autograd`):
the same launch forward, the plain version's vjp backward, the kernel on
the tangents forward.  Any other call dispatches straight to the kernel.

:func:`counts` reads, and :func:`reset_counts` zeroes, the kernels' launch
counts, the plain versions' call counts and the plain versions' runs as
the adjoints of a backward pass, so a run can show which of them its path
went through, K1's launches by the schedule they took, and the tallies of
the program's spans.  Each dispatch
function is the span ``ops_hook.<kernel>`` (host time only), one check of
the profiler's state when no profiler runs.
"""

from __future__ import annotations

from .ops.autograd import (
    DelayedAdd,
    FusedHead,
    GatherSupers,
    HeadMac,
    IrfftTail,
    RfftHalf,
    RotatedMac,
    XtGroupedMac,
    XtStepMac,
    needs_derivative,
)
from .ops.kernels import _build
from .utils import profiling
from .utils.profiling import span

__all__ = ["fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
           "gather_supers", "delayed_add", "head_mac", "rotated_mac",
           "xt_step_mac", "counts", "reset_counts"]


def fused_head(x, xcarry, prev, H, block: int):
    """K1: ``(y [C, T], xcarry', prev')`` for the head over ``x [C, T]``."""
    with span("ops_hook.fused_head"):
        if needs_derivative(x, xcarry, prev, H):
            return FusedHead.apply(x, xcarry, prev, H, block)
        return FusedHead.run(x, xcarry, prev, H, block)


def rfft_half(x, n: int):
    """K3: half-window spectrum ``[2, ..., n/2 + 1]`` of ``x [..., n/2]``."""
    with span("ops_hook.rfft_half"):
        if needs_derivative(x):
            return RfftHalf.apply(x, n)
        return RfftHalf.run(x, n)


def irfft_tail(planes, n: int):
    """K4: the last ``n/2`` samples of the inverse of ``[2, ..., n/2 + 1]``."""
    with span("ops_hook.irfft_tail"):
        if needs_derivative(planes):
            return IrfftTail.apply(planes, n)
        return IrfftTail.run(planes, n)


def xt_grouped_mac(queue, xt, H, slot0: int):
    """K2: the whole-group tail MAC ``[2, P, C, F]``."""
    with span("ops_hook.xt_grouped_mac"):
        if needs_derivative(queue, xt, H):
            return XtGroupedMac.apply(queue, xt, H, slot0)
        return XtGroupedMac.run(queue, xt, H, slot0)


def gather_supers(x, nsup: int):
    """K5: ``[C, T]`` -> ``[nsup, C, T // nsup]``."""
    with span("ops_hook.gather_supers"):
        if needs_derivative(x):
            return GatherSupers.apply(x, nsup)
        return GatherSupers.run(x, nsup)


def delayed_add(y_head, pending, out_tail):
    """K6: output assembly under the 2-slot pending schedule."""
    with span("ops_hook.delayed_add"):
        if needs_derivative(y_head, pending, out_tail):
            return DelayedAdd.apply(y_head, pending, out_tail)
        return DelayedAdd.run(y_head, pending, out_tail)


def head_mac(xext, H, ratio: int):
    """K7 (and K8): ``acc[i] = sum_p xext[P+i-p] * H[p]``, ``[2, ratio,
    C, F]``, from the first ``P + ratio`` slots of ``xext``."""
    with span("ops_hook.head_mac"):
        if needs_derivative(xext, H):
            return HeadMac.apply(xext, H, ratio)
        return HeadMac.run(xext, H, ratio)


def rotated_mac(queue, H, slot: int):
    """K9: ``acc = sum_p queue[(slot - p) % P] * H[p]``, ``[2, C, F]``."""
    with span("ops_hook.rotated_mac"):
        if needs_derivative(queue, H):
            return RotatedMac.apply(queue, H, slot)
        return RotatedMac.run(queue, H, slot)


def xt_step_mac(queue, xt, H, slot: int, retire: bool = False):
    """K2s: the tail's single super-step MAC ``[2, C, F]`` over the
    windows of ``queue`` (rolled to its oldest slot, ``slot``) and the new
    half spectrum ``xt [2, C, F]``.  With ``retire`` the same launch
    writes ``xt`` into ``queue[:, slot]``, in place: the caller owns the
    queue, and the call records no derivative."""
    with span("ops_hook.xt_step_mac"):
        if needs_derivative(queue, xt, H):
            if retire:
                raise ValueError("xt_step_mac cannot write the queue in "
                                 "place while it records a derivative")
            return XtStepMac.apply(queue, xt, H, slot)
        return XtStepMac.run(queue, xt, H, slot, retire)


def counts() -> dict:
    """``{"launches": {kernel: n}, "plain": {kernel: n}, "adjoint":
    {kernel: n}, "spans": {span: tally}}``, the last from
    :func:`~bbcat_dsp_torch.utils.profiling.tallies`."""
    return {"launches": dict(_build.LAUNCHES),
            "plain": dict(_build.PLAIN_CALLS),
            "adjoint": dict(_build.ADJOINT_CALLS),
            "spans": profiling.tallies()}


def reset_counts() -> None:
    for d in (_build.LAUNCHES, _build.PLAIN_CALLS, _build.ADJOINT_CALLS):
        for k in d:
            d[k] = 0
    profiling.reset_tallies()
