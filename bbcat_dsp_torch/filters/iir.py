"""The modal IIR engine: a time-invariant biquad as two complex one-pole
recurrences, parallel over time.

The counterpart of the modal realization in the JAX package's
``filters/iir.py``.  The biquad is factored on the host, in float64, into
its numerator FIR ``v[n] = d1 x[n-1] + d2 x[n-2]`` and its two poles;
then ``t[n] = p1 t[n-1] + v[n]``, ``w[n] = p2 w[n-1] + t[n]`` and ``y[n] =
b0 x[n] + Re w[n]``.  Each one-pole recurrence is an inclusive scan of
complex affine maps ``s -> a s + v``, computed one of two ways, chosen by
the JAX package's own gate so that both packages take the same branch at
every block length:

* **Toeplitz** (T a multiple of 128, T >= 256, at most 128 pole sets
  trailing the batch): within each 128-sample chunk the scan is a product
  with the upper-triangular matrix ``M[j, i] = p^(i-j)``, run as batched
  float32 matrix products at full precision (:func:`~bbcat_dsp_torch.
  utils.precision.full_f32`); the chunks couple through a scan of their
  carries, as in the JAX package.
* **General** (every other T): a log-depth doubling (Hillis-Steele) scan,
  log2(T) passes of shifted elementwise complex products.  The JAX package
  computes this scan with ``jax.lax.associative_scan`` in XLA, not in
  Pallas, so plain PyTorch is its counterpart.

Every function works on ``[..., T]`` tensors, time last, with the state as
explicit tensors: a stream continues across calls.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.precision import full_f32

__all__ = ["ModalParams", "ModalState", "modal_params", "modal_init",
           "modal_apply"]

# chunk length of the Toeplitz branch
_TOEP_CHUNK = 128


class ModalParams(NamedTuple):
    """Pole-factored biquad parameters, float32, all of one shape."""

    b0: torch.Tensor   # direct gain
    d1: torch.Tensor   # numerator FIR tap 1 (b1 - a1 b0)
    d2: torch.Tensor   # numerator FIR tap 2 (b2 - a2 b0)
    p1r: torch.Tensor  # pole 1 (real, imaginary)
    p1i: torch.Tensor
    p2r: torch.Tensor  # pole 2 (real, imaginary)
    p2i: torch.Tensor


class ModalState(NamedTuple):
    """Streaming state: the input history and the two complex one-pole
    states."""

    x1: torch.Tensor   # x[n-1]
    x2: torch.Tensor   # x[n-2]
    tr: torch.Tensor   # t after pole 1 (real, imaginary)
    ti: torch.Tensor
    wr: torch.Tensor   # w after pole 2 (real, imaginary)
    wi: torch.Tensor


def modal_params(coeffs, *, device) -> ModalParams:
    """Factor ``[..., 5]`` coefficients ``[b0, b1, b2, a1, a2]`` into poles
    and numerator FIR, on ``device``.

    The roots are found in float64 on the host.  Pass the float64 design:
    rounding the coefficients to float32 first costs about 30 dB for
    near-real pole pairs, through cancellation in the discriminant."""
    c = np.asarray(coeffs, np.float64)
    b0, b1, b2, a1, a2 = np.moveaxis(c, -1, 0)
    d1 = b1 - a1 * b0
    d2 = b2 - a2 * b0
    sq = np.sqrt((a1 * a1 - 4.0 * a2).astype(np.complex128))
    p1 = (-a1 + sq) / 2.0
    p2 = (-a1 - sq) / 2.0

    def dev(v):
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    return ModalParams(b0=dev(b0), d1=dev(d1), d2=dev(d2),
                       p1r=dev(p1.real), p1i=dev(p1.imag),
                       p2r=dev(p2.real), p2i=dev(p2.imag))


def modal_init(params: ModalParams, batch_shape=()) -> ModalState:
    """Silence: a zero state for a batch ``batch_shape`` broadcast with the
    parameters' shape, on the parameters' device."""
    shape = torch.broadcast_shapes(tuple(batch_shape), params.b0.shape)
    return ModalState(*(torch.zeros(shape, device=params.b0.device)
                        for _ in ModalState._fields))


def _pole_powers(p, n: int):
    """``p^0 .. p^(n-1)`` of complex64 poles along a new last axis, as a
    running product in complex128: one launch where the JAX package's
    float32 doubling takes eight rounds at n = 256, and exact to float32
    rounding."""
    pw = torch.cumprod(p.to(torch.complex128)[..., None].expand(
        *p.shape, n - 1), dim=-1)
    return torch.cat([torch.ones_like(pw[..., :1]), pw], -1).to(torch.complex64)


@functools.lru_cache(maxsize=None)
def _toeplitz_index(n: int, device: torch.device):
    """``max(c - r, 0)`` over ``[n, n]`` on ``device``, made once per
    device (n is the chunk length)."""
    r = torch.arange(n, device=device)
    return (r[None, :] - r[:, None]).clamp(min=0)


@functools.lru_cache(maxsize=64)
def _doubling_strides(T: int, device: torch.device):
    """The strides ``1, 2, 4, .. < T`` of the doubling scan, as a tuple
    and as an index on ``device`` (made once: indexing by a Python list
    would copy it from pageable host memory, which waits on the stream)."""
    strides = tuple(1 << k for k in range((T - 1).bit_length()))
    return strides, torch.tensor(strides, device=device)


def _toeplitz(pw, n: int):
    """``M[..., r, c] = pw[..., c - r]`` on and above the diagonal, zero
    below: ``[..., n, n]`` from powers ``pw [..., >= n]``."""
    return torch.triu(pw[..., _toeplitz_index(n, pw.device)])


def _cpx_affine_scan(pw, v, s0):
    """Inclusive scan of ``s[n] = p s[n-1] + v[n]`` (complex64) along the
    last axis of ``v``, for a pole ``p`` constant in time, from the states
    ``s0`` (the batch's shape): the whole trajectory.  ``pw [..., T + 1]``
    holds ``p^0 .. p^T`` and broadcasts against ``v``.

    Hillis-Steele doubling over the JAX package's compose ``(a, v) <- (a
    a', a v' + v)``: before the pass of stride ``d`` every element ``n >=
    d`` holds the map of the ``d`` samples up to it, whose ``a`` is ``p^d``
    whatever ``n`` is, so a pass is ``v[n] += p^d v[n - d]`` and ``a`` needs
    no scan of its own.  After log2(T) passes ``v[n]`` maps silence before
    sample 0 to sample ``n``, and ``s[n] = v[n] + p^(n+1) s0``.

    The passes ping-pong between two buffers that hold ``Z`` zeros (the
    largest stride) before the ``T`` samples, so the element ``d`` before
    sample ``n < d`` reads zero: one launch a pass."""
    T = v.shape[-1]
    strides, idx = _doubling_strides(T, v.device)
    if strides:
        Z = strides[-1]
        bufs = [v.new_zeros(v.shape[:-1] + (Z + T,)) for _ in range(2)]
        tails = [b.narrow(-1, Z, T) for b in bufs]
        tails[0].copy_(v)
        pd = pw.index_select(-1, idx).unsqueeze(-1).unbind(-2)  # p^d, [.., 1]
        for k, d in enumerate(strides):
            src = bufs[k % 2]
            torch.addcmul(tails[k % 2], pd[k], src.narrow(-1, Z - d, T),
                          out=tails[1 - k % 2])
        v = tails[len(strides) % 2]
    return torch.addcmul(v, pw[..., 1:], s0[..., None])


def _cpx_affine_scan_const(pw, M, qw, v, s0):
    """:func:`_cpx_affine_scan` as blocked Toeplitz products.

    ``s[i] = sum_{j <= i} p^(i-j) v[j] + p^(i+1) s0``: within a chunk of L
    samples the sum is ``v_chunk @ M`` with ``M[j, i] = p^(i-j)`` on and
    above the diagonal.  The chunks couple through the carries into them,
    ``c[m] = p^(Lm) s0 + sum_{k < m} p^(L(m-1-k)) e[k]`` over the chunks'
    last samples ``e``: the doubling scan of ``c[m] = p^L c[m-1] + e[m]``,
    as the JAX package scans them.  ``pw [K, L + 1]`` holds ``p^0 ..
    p^L``, ``M [K, L, L]``, ``qw [K, n + 1]`` the powers ``p^0 .. p^(nL)``
    in steps of L; ``v [K, B, T]`` real or complex, ``T = n L``; ``s0 [K,
    B]``."""
    K, Bb, T = v.shape
    L = _TOEP_CHUNK
    n = T // L
    rows = v.reshape(K, Bb * n, L)
    with full_f32():
        if v.is_complex():
            y = torch.matmul(rows, M)
        else:
            # a real input takes one real product with M's re/im
            # interleaved per column, read back as complex
            y = torch.view_as_complex(torch.matmul(
                rows, torch.view_as_real(M).reshape(K, L, 2 * L)
            ).reshape(K, Bb * n, L, 2))
    y = y.reshape(K, Bb, n, L)
    c = _cpx_affine_scan(qw[:, None], y[..., -1], s0)          # out of m
    c = torch.cat([s0[..., None], c[..., :-1]], -1)            # into m
    # p^(i+1) times the carry, into every sample of the chunk
    s = torch.addcmul(y, pw[:, None, None, 1:], c[..., None])
    return s.reshape(K, Bb, T)


def modal_apply(x: torch.Tensor, params: ModalParams,
                state: ModalState | None = None):
    """Run a time-invariant biquad in the modal realization over ``x [...,
    T]`` (T >= 2): ``(y, state')``, every state tensor contiguous."""
    T = x.shape[-1]
    if T < 2:
        raise ValueError(f"modal_apply needs T >= 2 samples, got {T}")
    if state is None:
        state = modal_init(params, x.shape[:-1])
    b = tuple(torch.broadcast_shapes(x.shape[:-1], params.b0.shape))
    full = b + (T,)
    xb = x.expand(full)

    # [x[-2], x[-1], x[0] .. x[T-1]]: x[n-1] and x[n-2] are views of it
    xh = torch.cat([state.x2.expand(b)[..., None],
                    state.x1.expand(b)[..., None], xb], -1)
    xm1, xm2 = xh[..., 1:T + 1], xh[..., :T]
    v = torch.addcmul(params.d1[..., None] * xm1, params.d2[..., None], xm2)
    # both poles in one tensor, so their powers take one set of launches
    poles = torch.complex(torch.stack([params.p1r, params.p2r]),
                          torch.stack([params.p1i, params.p2i]))
    t0 = torch.complex(state.tr, state.ti).expand(b)
    w0 = torch.complex(state.wr, state.wi).expand(b)

    ps = tuple(params.b0.shape)
    kn = math.prod(ps)
    if (T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK and kn <= 128
            and b[len(b) - len(ps):] == ps):
        # constant poles, pole dims trailing the batch: [lead..., K, T] ->
        # [K, lead, T], so each pole's chunk matrices batch on K
        Bf = math.prod(b[:len(b) - len(ps)])

        def to_kbt(a):
            return a.reshape((Bf, kn) + tuple(a.shape[len(b):])).transpose(0, 1)

        def from_kbt(a):
            return a.transpose(0, 1).reshape(b + tuple(a.shape[2:]))

        # both poles' chunk matrices and carry powers at once
        L, n = _TOEP_CHUNK, T // _TOEP_CHUNK
        pw = _pole_powers(poles.reshape(2, kn), L + 1)
        M = _toeplitz(pw, L)
        qw = _pole_powers(pw[..., L], n + 1)
        t = _cpx_affine_scan_const(pw[0], M[0], qw[0], to_kbt(v), to_kbt(t0))
        w = _cpx_affine_scan_const(pw[1], M[1], qw[1], t, to_kbt(w0))
        t, w = from_kbt(t), from_kbt(w)
    else:
        pw = _pole_powers(poles, T + 1)
        t = _cpx_affine_scan(pw[0], v.to(torch.complex64), t0)
        w = _cpx_affine_scan(pw[1], t, w0)
    y = torch.addcmul(w.real, params.b0[..., None], xb)
    # the six state leaves in one copy; each is a contiguous slice of it
    last = torch.stack([xb[..., -1], xm1[..., -1], t.real[..., -1],
                        t.imag[..., -1], w.real[..., -1], w.imag[..., -1]])
    return y, ModalState(*last.unbind(0))
