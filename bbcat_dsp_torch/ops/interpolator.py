"""Click-free parameter interpolators.

The counterpart of the JAX package's ``ops/interpolator.py``: small
named tuples of tensors whose per-sample ramps are materialised as vectors
for whatever consumes them (a mix, a filter), instead of a loop over
samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Interpolator", "interpolator", "interp_ramp",
           "ComplexInterpolator", "complex_interpolator",
           "complex_interp_ramp"]


class Interpolator(NamedTuple):
    """A clamped linear ramp from ``current`` to ``target``."""

    current: torch.Tensor
    target: torch.Tensor

    @property
    def nonzero(self) -> torch.Tensor:
        """Either end is nonzero."""
        return (self.current != 0) | (self.target != 0)

    @property
    def at_target(self) -> torch.Tensor:
        return self.current == self.target


def interpolator(current=0.0, target=0.0, dtype=torch.float32, *,
                 device) -> Interpolator:
    return Interpolator(torch.as_tensor(current, dtype=dtype, device=device),
                        torch.as_tensor(target, dtype=dtype, device=device))


def interp_ramp(it: Interpolator, inc, nframes: int):
    """``(ramp [nframes], advanced interpolator)`` of a scalar
    interpolator: the value before each frame's step of ``|inc|`` toward
    the target, clamped there."""
    cur, tgt = it.current, it.target
    inc = torch.as_tensor(inc, dtype=cur.dtype, device=cur.device).abs()
    n = torch.arange(nframes, dtype=cur.dtype, device=cur.device)
    rising = cur <= tgt
    ramp = torch.where(rising, torch.minimum(cur + inc * n, tgt),
                       torch.maximum(cur - inc * n, tgt))
    new_cur = torch.where(rising, torch.minimum(cur + inc * nframes, tgt),
                          torch.maximum(cur - inc * nframes, tgt))
    return ramp, Interpolator(new_cur, tgt)


class ComplexInterpolator(NamedTuple):
    """One controller, from 1 down to 0, that moves a group of values so
    that all of them reach their targets together."""

    controller: torch.Tensor  # [] in [0, 1]
    targets: torch.Tensor     # [...]
    diffs: torch.Tensor       # [...] target - value when set


def complex_interpolator(values, targets, dtype=torch.float32, *,
                         device) -> ComplexInterpolator:
    values = torch.as_tensor(values, dtype=dtype, device=device)
    targets = torch.as_tensor(targets, dtype=dtype, device=device)
    return ComplexInterpolator(torch.ones((), dtype=dtype, device=device),
                               targets, targets - values)


def complex_interp_ramp(ci: ComplexInterpolator, dec, nframes: int):
    """``(values [..., nframes], advanced interpolator)``: each frame's
    ``target - controller * diff``, the controller falling by ``dec`` a
    frame to 0."""
    ctl0 = ci.controller
    dec = torch.as_tensor(dec, dtype=ctl0.dtype, device=ctl0.device)
    n = torch.arange(nframes, dtype=ctl0.dtype, device=ctl0.device)
    ctl = torch.clamp(ctl0 - dec * n, min=0.0)
    vals = ci.targets[..., None] - ctl * ci.diffs[..., None]
    return vals, ci._replace(controller=torch.clamp(ctl0 - dec * nframes,
                                                    min=0.0))
