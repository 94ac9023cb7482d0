"""All-pass and feedback comb filters as scans over the delay's phases:
the counterparts of the JAX package's ``filters/allpass.py``.

The all-pass ``y[n] = c x[n] + w[n-d]``, ``w[n] = x[n] - c y[n]`` is, with
``y`` substituted, a recurrence on ``w`` alone with one tap at lag ``d``:

    w[n] = (1 - c^2) x[n] - c w[n-d]

so the ``d`` phases ``n mod d`` are ``d`` independent first-order
recurrences with a constant multiplier, each over ``m = ceil(T / d)``
samples.  Their scan is the constant-pole doubling of the modal engine,
``v[k] += beta^j v[k - j]`` for ``j = 1, 2, 4, ..`` along the ``m`` axis;
a block no longer than the delay (``m = 1``) needs no scan at all.  The
state of a channel is the ring of its last ``d`` values of ``w`` (of ``y``
for the comb), oldest first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["allpass_apply", "comb_apply", "AllPassFilter",
           "AllPassFilterChain"]


def _lag_scan(v: torch.Tensor, beta: float, ring: torch.Tensor):
    """``s[n] = beta s[n-d] + v[n]`` over ``v [..., T]`` from the ring
    ``[..., d]`` of the last ``d`` values of ``s``: ``(s_prev, s, ring')``
    with ``s_prev[n] = s[n-d]``, both ``[..., T]``."""
    T, d = v.shape[-1], ring.shape[-1]
    m = -(-T // d)
    vb = F.pad(v, (0, m * d - T)).reshape(v.shape[:-1] + (m, d))
    j = 1
    while j < m:       # v[k] += beta^j v[k - j], rows before the first zero
        vb = torch.add(vb, F.pad(vb[..., :-j, :], (0, 0, j, 0)),
                       alpha=beta ** j)
        j *= 2
    if m == 1:
        s = beta * ring[..., None, :] + vb
    else:
        bcum = torch.pow(beta, torch.arange(1, m + 1, device=v.device,
                                            dtype=v.dtype))
        s = bcum[:, None] * ring[..., None, :] + vb
    s_prev = torch.cat([ring[..., None, :], s[..., :-1, :]], -2)
    flat = v.shape[:-1] + (m * d,)
    s = s.reshape(flat)[..., :T]
    # the last d values, oldest first; a block shorter than the delay
    # keeps the newest part of the old ring
    new_ring = s[..., T - d:] if T >= d else torch.cat([ring[..., T:], s], -1)
    return s_prev.reshape(flat)[..., :T], s, new_ring


def allpass_apply(x: torch.Tensor, coeff: float, delay: int,
                  w_ring: torch.Tensor | None = None):
    """The all-pass with coefficient ``coeff`` and integer ``delay`` over
    ``x [..., T]``: ``(y, w_ring')``.  ``w_ring [..., delay]`` holds the
    last ``delay`` values of ``w``, oldest first (``w_ring[..., i] = w[n0 -
    delay + i]``); silence when ``None``."""
    c, d = float(coeff), int(delay)
    if w_ring is None:
        w_ring = x.new_zeros(x.shape[:-1] + (d,))
    w_prev, _, new_ring = _lag_scan((1.0 - c * c) * x, -c, w_ring)
    return c * x + w_prev, new_ring


def comb_apply(x: torch.Tensor, feedback: float, delay: int,
               y_ring: torch.Tensor | None = None):
    """The feedback comb ``y[n] = x[n] + g y[n - delay]`` over ``x [...,
    T]``: ``(y, y_ring')``, the ring the last ``delay`` outputs."""
    d = int(delay)
    if y_ring is None:
        y_ring = x.new_zeros(x.shape[:-1] + (d,))
    _, y, new_ring = _lag_scan(x, float(feedback), y_ring)
    return y, new_ring


class AllPassFilter:
    """An all-pass over ``nchannels`` channels on ``device``."""

    def __init__(self, nchannels: int, delay: int, coeff: float,
                 dtype=torch.float32, *, device):
        self.delay = int(delay)
        self.coeff = float(coeff)
        self.w = torch.zeros((nchannels, self.delay), dtype=dtype,
                             device=device)

    def process(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.w.dtype, device=self.w.device)
        y, self.w = allpass_apply(x, self.coeff, self.delay, self.w)
        return y

    def reset(self) -> None:
        self.w = torch.zeros_like(self.w)


class AllPassFilterChain:
    """All-pass filters one after the other."""

    def __init__(self, filters):
        self.filters = list(filters)

    def process(self, x) -> torch.Tensor:
        for f in self.filters:
            x = f.process(x)
        return x

    def reset(self) -> None:
        for f in self.filters:
            f.reset()
