"""The IIR engines: the modal one for a time-invariant biquad (two
complex one-pole recurrences, parallel over time) and, further down, the
companion-form ones for coefficients that change from sample to sample
(:func:`biquad_apply`, :func:`cascade_apply`).

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

A whole static cascade of S biquads also runs in one go, in its parallel
(partial-fraction) form: ``H(u) = c + sum_j r_j / (1 - p_j u)`` over its 2S
poles, 2S independent one-pole recurrences on the same two scans, the
poles as one more batch axis (:func:`parallel_cascade_apply`).

Parameters in bfloat16 or float16 (``modal_params(..., dtype=...)``,
``parallel_cascade_params(coeffs, dtype)``), or a signal in one, take the
JAX package's narrow arithmetic, written out step by step rather than
left to promotion: the pole powers by its doubling in the parameters'
type, the scans by its odd-even recursion (``jax.lax.associative_scan``)
with the maps' poles in that type, and everything else in the type the
reference computes mixed operands in (float32 against a float32 signal,
the narrow type where signal, parameters and state all are).  A float32
or float64 engine never enters that path.

Every function works on ``[..., T]`` tensors, time last, with the state as
explicit tensors: a stream continues across calls.  :func:`modal_apply`
is differentiable in both modes, in the signal, the parameters and the
state: the doubling scan writes its passes into two buffers, and takes
them out of place when a derivative is recorded.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.autograd import needs_derivative
from ..utils.precision import (NARROW, full_f32, host_tensor, promoted,
                               storage_dtype, sum_in_order)

__all__ = ["ModalParams", "ModalState", "modal_params", "modal_init",
           "modal_apply", "modal_from_df2t", "ParallelCascadeParams",
           "ParallelCascadeState", "parallel_cascade_params",
           "parallel_cascade_apply", "biquad_ssm", "biquad_apply",
           "cascade_apply", "interp_trajectory"]

# chunk length of the Toeplitz branch
_TOEP_CHUNK = 128


class ModalParams(NamedTuple):
    """Pole-factored biquad parameters, all of one shape and type."""

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


def modal_params(coeffs, *, device, dtype=torch.float32) -> ModalParams:
    """Factor ``[..., 5]`` coefficients ``[b0, b1, b2, a1, a2]`` into poles
    and numerator FIR, ``dtype`` (float32, bfloat16, float16, or float64,
    in which the port computes) on ``device``.

    The roots are found in float64 on the host and rounded once to
    ``dtype``.  Pass the float64 design: rounding the coefficients to
    float32 first costs about 30 dB for near-real pole pairs, through
    cancellation in the discriminant."""
    dtype = storage_dtype(dtype, "modal_params", float64=True)
    c = np.asarray(coeffs, np.float64)
    b0, b1, b2, a1, a2 = np.moveaxis(c, -1, 0)
    d1 = b1 - a1 * b0
    d2 = b2 - a2 * b0
    sq = np.sqrt((a1 * a1 - 4.0 * a2).astype(np.complex128))
    p1 = (-a1 + sq) / 2.0
    p2 = (-a1 - sq) / 2.0

    # one copy to the device; the seven fields are slices of it
    host = np.stack([b0, d1, d2, p1.real, p1.imag, p2.real, p2.imag])
    return ModalParams(*host_tensor(host, dtype, device).unbind(0))


def modal_init(params: ModalParams, batch_shape=(),
               dtype=None) -> ModalState:
    """Silence: a zero state for a batch ``batch_shape`` broadcast with the
    parameters' shape, on the parameters' device, in ``dtype``: by
    default float64 for float64 parameters, else float32 (the reference's
    default)."""
    if dtype is None:
        dtype = (torch.float64 if params.b0.dtype == torch.float64
                 else torch.float32)
    dtype = storage_dtype(dtype, "modal_init", float64=True)
    shape = torch.broadcast_shapes(tuple(batch_shape), params.b0.shape)
    return ModalState(*(torch.zeros(shape, dtype=dtype,
                                    device=params.b0.device)
                        for _ in ModalState._fields))


def _pole_powers(p, n: int):
    """``p^0 .. p^(n-1)`` of complex poles along a new last axis, as a
    running product in complex128: one launch where the JAX package's
    float32 doubling takes eight rounds at n = 256, and exact to float32
    rounding."""
    pw = torch.cumprod(p.to(torch.complex128)[..., None].expand(
        *p.shape, n - 1), dim=-1)
    return torch.cat([torch.ones_like(pw[..., :1]), pw], -1).to(p.dtype)


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
    """Inclusive scan of ``s[n] = p s[n-1] + v[n]`` (complex) along the
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
    if strides and needs_derivative(pw, v, s0):
        # autograd records no ``out=``: each pass takes a new tensor
        pd = pw.index_select(-1, idx).unsqueeze(-1).unbind(-2)
        for k, d in enumerate(strides):
            shifted = torch.cat([torch.zeros_like(v[..., :d]),
                                 v[..., :T - d]], -1)
            v = torch.addcmul(v, pd[k], shifted)
    elif strides:
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


def _toeplitz_layout(T: int, b: tuple, ps: tuple):
    """The modal engine's gate for the Toeplitz branch, the JAX package's:
    T a multiple of 128, T >= 256, at most 128 pole sets ``ps`` trailing
    the batch ``b``.  Then ``(to_kbt, from_kbt, K)``: ``[lead..., K, ...]``
    <-> ``[K, lead, ...]``, so each pole's chunk matrices batch on K;
    else None."""
    kn = math.prod(ps)
    if not (T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK and kn <= 128
            and b[len(b) - len(ps):] == ps):
        return None
    Bf = math.prod(b[:len(b) - len(ps)])

    def to_kbt(a):
        return a.reshape((Bf, kn) + tuple(a.shape[len(b):])).transpose(0, 1)

    def from_kbt(a):
        return a.transpose(0, 1).reshape(b + tuple(a.shape[2:]))

    return to_kbt, from_kbt, kn


def modal_apply(x: torch.Tensor, params: ModalParams,
                state: ModalState | None = None):
    """Run a time-invariant biquad in the modal realization over ``x [...,
    T]`` (T >= 2): ``(y, state')``, every state tensor contiguous."""
    T = x.shape[-1]
    if T < 2:
        raise ValueError(f"modal_apply needs T >= 2 samples, got {T}")
    if x.dtype in NARROW or params.b0.dtype in NARROW:
        return _modal_apply_narrow(x, params, state)
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

    kbt = _toeplitz_layout(T, b, tuple(params.b0.shape))
    if kbt is not None:
        to_kbt, from_kbt, kn = kbt
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
        t = _cpx_affine_scan(pw[0], v.to(poles.dtype), t0)
        w = _cpx_affine_scan(pw[1], t, w0)
    y = torch.addcmul(w.real, params.b0[..., None], xb)
    # the six state leaves in one copy; each is a contiguous slice of it
    last = torch.stack([xb[..., -1], xm1[..., -1], t.real[..., -1],
                        t.imag[..., -1], w.real[..., -1], w.imag[..., -1]])
    return y, ModalState(*last.unbind(0))


# ---- narrow parameters or signals: the JAX package's arithmetic -------------------
#
# The reference computes these paths in whatever type JAX promotes each
# operation to.  Here every operand is cast to that type explicitly
# (``_in``), so each operation's type is written out: an elementwise
# operation on bfloat16 or float16 operands rounds its result to their
# type, a sum of a narrow operand runs in float32 and rounds once (as
# ``jnp.sum`` does), and a matrix product in a narrow type runs in float32
# on the widened operands and rounds its result once.  These are the
# reference's semantics operation by operation (``jax.disable_jit``),
# which the port meets bit for bit; compiled, XLA:CPU may keep float16
# values at float32 inside a fusion (see ``tests/test_torch_narrow.py``).


def _in(dt: torch.dtype, *ts: torch.Tensor):
    return tuple(t.to(dt) for t in ts)


def _narrow_pole_powers(pr, pi, n: int):
    """``p^0 .. p^(m-1)`` (``m >= n``, a power of two) along a new last
    axis, as ``(re, im)`` by the JAX package's doubling in the poles' own
    type: ``p^(m+k) = p^m p^k``, every product and sum rounded."""
    powr = torch.ones(pr.shape + (1,), dtype=pr.dtype, device=pr.device)
    powi = torch.zeros_like(powr)
    while powr.shape[-1] < n:
        lr = powr[..., -1] * pr - powi[..., -1] * pi
        li = powr[..., -1] * pi + powi[..., -1] * pr
        powr, powi = (
            torch.cat([powr, lr[..., None] * powr - li[..., None] * powi], -1),
            torch.cat([powi, lr[..., None] * powi + li[..., None] * powr], -1))
    return powr, powi


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` at the even, ``b`` at the odd places of the last axis (``a``
    is as long as ``b`` or one longer)."""
    n = b.shape[-1]
    pairs = torch.stack([a[..., :n], b], -1).flatten(-2)
    return torch.cat([pairs, a[..., n:]], -1)


def _assoc_scan(compose, elems: tuple) -> tuple:
    """Inclusive scan of ``elems`` (tensors, time last) under ``compose(f,
    g)`` (``f`` earlier) by ``jax.lax.associative_scan``'s odd-even
    recursion: every element is composed in the reference's order, so it
    rounds where the reference rounds."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _assoc_scan(compose, compose(tuple(e[..., 0:n - 1:2] for e in elems),
                                       tuple(e[..., 1::2] for e in elems)))
    rest = tuple(e[..., 2::2] for e in elems)
    even = compose(tuple(o[..., :-1] for o in odd) if n % 2 == 0 else odd,
                   rest)
    even = tuple(torch.cat([e[..., :1], r], -1) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _narrow_cpx_scan(ar, ai, vr, vi, s0r, s0i, cd: torch.dtype):
    """The JAX package's ``_cpx_affine_scan``: ``s[n] = a[n] s[n-1] +
    v[n]`` along the last axis from ``s0`` (the batch's shape), the maps'
    ``a`` composed in their own type, ``v`` and ``s`` in ``cd``."""

    def compose(f, g):
        far, fai, fvr, fvi = f
        gar, gai, gvr, gvi = g
        gr, gi = _in(cd, gar, gai)
        return (gar * far - gai * fai, gar * fai + gai * far,
                gr * fvr - gi * fvi + gvr, gr * fvi + gi * fvr + gvi)

    car, cai, cvr, cvi = _assoc_scan(compose, (ar, ai) + _in(cd, vr, vi))
    cr, ci = _in(cd, car, cai)
    s0r, s0i = (t[..., None] for t in _in(cd, s0r, s0i))
    return cr * s0r - ci * s0i + cvr, cr * s0i + ci * s0r + cvi


def _narrow_bmm(a, m, cd: torch.dtype):
    """``[K, B, n, L] @ [K, L, L]`` in ``cd``; a narrow ``cd`` runs the
    product in float32 and rounds its result.  The rows go in as one
    ``[K, B n, L]`` batch: with ``m`` broadcast over a stride-0 batch axis
    the CPU takes ATen's own loop, which rounds every product before it
    adds (no FMA), where the reference's dot and the strided batched
    product fuse each multiply-add in sequence."""
    K, Bb, n, L = a.shape
    rows = a.reshape(K, Bb * n, L)
    with full_f32():
        if cd in NARROW:
            y = torch.bmm(rows.float(), m.float()).to(cd)
        else:
            y = torch.bmm(rows, m)
    return y.reshape(K, Bb, n, L)


def _narrow_scan_const(pr, pi, vr, vi, s0r, s0i, cd: torch.dtype):
    """The JAX package's ``_cpx_affine_scan_const`` for poles ``pr, pi
    [K]`` and ``v [K, B, T]`` (``vi`` None for a real input), ``s0 [K,
    B]``: the chunk matrices from the poles' doubled powers, the products
    and the carry scan in ``cd``."""
    K, Bb, T = vr.shape
    L = _TOEP_CHUNK
    n = T // L
    powr, powi = _narrow_pole_powers(pr, pi, 2 * L)          # [K, 2L]
    idx = _toeplitz_index(L, pr.device)
    Mr, Mi = (torch.triu(t) for t in _in(cd, powr[:, idx], powi[:, idx]))
    vcr = vr.to(cd).reshape(K, Bb, n, L)
    if vi is None:
        yr, yi = _narrow_bmm(vcr, Mr, cd), _narrow_bmm(vcr, Mi, cd)
    else:
        vci = vi.to(cd).reshape(K, Bb, n, L)
        yr = _narrow_bmm(vcr, Mr, cd) - _narrow_bmm(vci, Mi, cd)
        yi = _narrow_bmm(vcr, Mi, cd) + _narrow_bmm(vci, Mr, cd)
    er, ei = yr[..., -1], yi[..., -1]                        # [K, B, n]
    cr, ci = _narrow_cpx_scan(powr[:, L, None, None].expand(er.shape),
                              powi[:, L, None, None].expand(er.shape),
                              er, ei, s0r, s0i, cd)
    s0r, s0i = _in(cd, s0r, s0i)
    cpr = torch.cat([s0r[..., None], cr[..., :-1]], -1)      # carry into m
    cpi = torch.cat([s0i[..., None], ci[..., :-1]], -1)
    pwr, pwi = _in(cd, powr[:, None, None, 1:L + 1], powi[:, None, None, 1:L + 1])
    sr = yr + pwr * cpr[..., None] - pwi * cpi[..., None]
    si = yi + pwr * cpi[..., None] + pwi * cpr[..., None]
    return sr.reshape(K, Bb, T), si.reshape(K, Bb, T)


def _modal_apply_narrow(x, params: ModalParams, state: ModalState | None):
    """:func:`modal_apply` where the parameters or the signal are bfloat16
    or float16: the JAX package's ``modal_apply`` step by step, in the
    type it promotes each operand to (``cd``: float32 against a float32
    signal or state, the narrow type where all three are narrow).  The
    output and the state are in ``cd``."""
    T = x.shape[-1]
    if state is None:
        state = modal_init(params, x.shape[:-1], x.dtype)
    cd = promoted(x.dtype, params.b0.dtype, *(t.dtype for t in state))
    b = tuple(torch.broadcast_shapes(x.shape[:-1], params.b0.shape))
    full = b + (T,)
    (xb,) = _in(cd, x.expand(full))
    x1, x2 = (t.expand(b)[..., None] for t in _in(cd, state.x1, state.x2))
    xm1 = torch.cat([x1, xb[..., :-1]], -1)
    xm2 = torch.cat([x2, x1, xb[..., :-2]], -1)
    d1, d2, b0 = (t[..., None] for t in _in(cd, params.d1, params.d2,
                                            params.b0))
    v = d1 * xm1 + d2 * xm2
    s0 = tuple(t.expand(b) for t in _in(cd, state.tr, state.ti, state.wr,
                                        state.wi))
    ps = tuple(params.b0.shape)
    kbt = _toeplitz_layout(T, b, ps)
    if kbt is not None:
        to_kbt, from_kbt, kn = kbt
        p1r, p1i, p2r, p2i = (t.reshape(kn) for t in (params.p1r, params.p1i,
                                                      params.p2r, params.p2i))
        tr, ti = _narrow_scan_const(p1r, p1i, to_kbt(v), None,
                                    to_kbt(s0[0]), to_kbt(s0[1]), cd)
        wr, wi = _narrow_scan_const(p2r, p2i, tr, ti, to_kbt(s0[2]),
                                    to_kbt(s0[3]), cd)
        tr, ti, wr, wi = (from_kbt(t) for t in (tr, ti, wr, wi))
    else:
        # the poles along time, broadcast: the maps' products are one a
        # pole set, shared by the batch
        p1r, p1i, p2r, p2i = (t[..., None].expand(ps + (T,)) for t in
                              (params.p1r, params.p1i, params.p2r, params.p2i))
        tr, ti = _narrow_cpx_scan(p1r, p1i, v, torch.zeros_like(v), s0[0],
                                  s0[1], cd)
        wr, wi = _narrow_cpx_scan(p2r, p2i, tr, ti, s0[2], s0[3], cd)
    y = b0 * xb + wr
    last = torch.stack([xb[..., -1], xm1[..., -1], tr[..., -1], ti[..., -1],
                        wr[..., -1], wi[..., -1]])
    return y, ModalState(*last.unbind(0))


class ParallelCascadeParams(NamedTuple):
    """The parallel (partial-fraction) form of a whole biquad cascade:
    ``H(u) = c + sum_j r_j / (1 - p_j u)`` over its ``K = 2 S`` simple
    poles, of one type on one device."""

    c: torch.Tensor    # [] direct gain
    pr: torch.Tensor   # [K] poles (real, imaginary)
    pi: torch.Tensor
    rr: torch.Tensor   # [K] residues (real, imaginary)
    ri: torch.Tensor


class ParallelCascadeState(NamedTuple):
    """The K one-pole states, ``[K, ...batch]`` (real, imaginary)."""

    sr: torch.Tensor
    si: torch.Tensor


def parallel_cascade_params(coeffs, dtype=torch.float32,
                            min_pole_dist: float = 1e-4, *,
                            device) -> ParallelCascadeParams:
    """Factor ``[S, 5]`` host coefficients into the parallel form, in
    float64, and round it once to ``dtype`` (float32, bfloat16, float16,
    or float64, in which the port computes) on ``device``.

    The residues come from the factored form (each biquad's own quadratic):
    expanding the 2S-order polynomials would wreck the poles.  Raises
    ``ValueError`` where the decomposition is ill-conditioned (a pole on or
    outside the unit circle, repeated or clustered poles, a zero pole, huge
    residues); callers then run the stages one after the other through
    :func:`modal_apply`."""
    c = np.atleast_2d(np.asarray(coeffs, np.float64))
    poles = []
    for _, _, _, a1, a2 in c:
        sq = np.sqrt(complex(a1 * a1 - 4.0 * a2))
        poles += [(-a1 + sq) / 2.0, (-a1 - sq) / 2.0]
    poles = np.asarray(poles)
    if np.abs(poles).max() >= 1.0:
        raise ValueError("unstable cascade")
    K = poles.size
    dist = np.abs(poles[:, None] - poles[None, :]) + np.eye(K)
    if dist.min() < min_pole_dist:
        raise ValueError("clustered/repeated poles: parallel form "
                         "ill-conditioned; use the serial modal engine")
    if not np.all(c[:, 4] != 0):
        raise ValueError("zero pole (a2 == 0): use the serial modal engine")
    c_direct = float(np.prod(c[:, 2]) / np.prod(c[:, 4]))
    u = 1.0 / poles
    num = np.prod(c[:, 0, None] + c[:, 1, None] * u + c[:, 2, None] * u * u,
                  axis=0)
    r = np.empty(K, complex)
    for j in range(K):
        r[j] = num[j] / np.prod(np.delete(1.0 - poles * u[j], j))
    if not np.all(np.isfinite(r)) or np.abs(r).max() > 1e6:
        raise ValueError("huge residues: parallel form ill-conditioned")
    dtype = storage_dtype(dtype, "parallel_cascade_params", float64=True)

    def dev(v):
        return host_tensor(v, dtype, device)

    return ParallelCascadeParams(c=dev(c_direct), pr=dev(poles.real),
                                 pi=dev(poles.imag), rr=dev(r.real),
                                 ri=dev(r.imag))


def parallel_cascade_apply(x: torch.Tensor, params: ParallelCascadeParams,
                           state: ParallelCascadeState | None = None):
    """The whole cascade over ``x [..., T]`` as one batched complex scan
    over its K poles: ``(y, state')``.  Long blocks (T a multiple of 128, T
    >= 256) take the Toeplitz products, every other T the doubling scan,
    the JAX package's own gate."""
    T = x.shape[-1]
    K = params.pr.shape[0]
    batch = tuple(x.shape[:-1])
    if state is None:
        z = x.new_zeros((K,) + batch)
        state = ParallelCascadeState(z, z)
    if x.dtype in NARROW or params.pr.dtype in NARROW:
        return _parallel_cascade_apply_narrow(x, params, state)
    poles = torch.complex(params.pr, params.pi)
    s0 = torch.complex(state.sr, state.si)
    xb = x.expand((K,) + batch + (T,))
    if T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK:
        L, n = _TOEP_CHUNK, T // _TOEP_CHUNK
        Bf = math.prod(batch)
        pw = _pole_powers(poles, L + 1)
        qw = _pole_powers(pw[..., L], n + 1)
        s = _cpx_affine_scan_const(pw, _toeplitz(pw, L), qw,
                                   xb.reshape(K, Bf, T), s0.reshape(K, Bf))
        s = s.reshape((K,) + batch + (T,))
    else:
        pw = _pole_powers(poles, T + 1)
        pw = pw.reshape((K,) + (1,) * len(batch) + (T + 1,))
        s = _cpx_affine_scan(pw, xb.to(poles.dtype), s0)
    shape_k = (K,) + (1,) * (len(batch) + 1)
    rr, ri = params.rr.reshape(shape_k), params.ri.reshape(shape_k)
    y = params.c * x + (rr * s.real - ri * s.imag).sum(0)
    last = torch.stack([s.real[..., -1], s.imag[..., -1]])
    return y, ParallelCascadeState(*last.unbind(0))


def _parallel_cascade_apply_narrow(x, params: ParallelCascadeParams,
                                   state: ParallelCascadeState):
    """:func:`parallel_cascade_apply` where the parameters or the signal
    are bfloat16 or float16, as :func:`_modal_apply_narrow` runs the modal
    engine: the JAX package's steps in the types it promotes to."""
    T = x.shape[-1]
    K = params.pr.shape[0]
    batch = tuple(x.shape[:-1])
    cd = promoted(x.dtype, params.pr.dtype, state.sr.dtype, state.si.dtype)
    (xb,) = _in(cd, x.expand((K,) + batch + (T,)))
    shape_k = (K,) + (1,) * len(batch) + (1,)
    if T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK:
        Bf = math.prod(batch)
        sr, si = _narrow_scan_const(params.pr, params.pi, xb.reshape(K, Bf, T),
                                    None, state.sr.reshape(K, Bf),
                                    state.si.reshape(K, Bf), cd)
        sr, si = sr.reshape(xb.shape), si.reshape(xb.shape)
    else:
        ar, ai = (t.reshape(shape_k).expand(shape_k[:-1] + (T,))
                  for t in (params.pr, params.pi))
        sr, si = _narrow_cpx_scan(ar, ai, xb, torch.zeros_like(xb), state.sr,
                                  state.si, cd)
    rr, ri, c = _in(cd, params.rr.reshape(shape_k), params.ri.reshape(shape_k),
                    params.c)
    mix = rr * sr - ri * si
    # the reference's sum takes a narrow operand in float32, rounds once
    mix = sum_in_order(mix, 0).to(cd) if cd in NARROW else mix.sum(0)
    y = c * x.to(cd) + mix
    last = torch.stack([sr[..., -1], si[..., -1]])
    return y, ParallelCascadeState(*last.unbind(0))


def modal_from_df2t(params: ModalParams, w_state: torch.Tensor) -> ModalState:
    """The :class:`ModalState` whose zero-input response equals that of the
    DF2T registers ``w_state [..., 2]``, so a stream changes realization
    (at the end of a coefficient ramp) without a click.

    The DF2T free decay is ``y[n] = c1 p1^n + c2 p2^n`` with ``y[0] = w0``
    and ``y[1] = -a1 w0 + w1``; the modal one, with the FIR history at
    zero, is ``Re(alpha p1^n + beta p2^n)`` with ``alpha = T0 p1^2 / (p1 -
    p2)`` and ``beta = p2 W0 - T0 p1 p2 / (p1 - p2)``.  A complex pair
    takes ``alpha = 2 c1, beta = 0``; real distinct poles ``alpha = c1,
    beta = c2``; a repeated pole, ``p2 == 0`` and all-zero poles their
    limits."""
    w0, w1 = w_state[..., 0], w_state[..., 1]
    p1 = torch.complex(params.p1r, params.p1i)
    p2 = torch.complex(params.p2r, params.p2i)
    a1 = -(p1 + p2).real
    y0 = w0
    y1 = -a1 * w0 + w1

    tol = 1e-6
    one = torch.ones_like(p1)
    dp = p1 - p2
    dp_safe = torch.where(dp.abs() < tol, one, dp)
    p1_safe = torch.where(p1.abs() < tol, one, p1)
    p2_safe = torch.where(p2.abs() < tol, one, p2)
    c1 = (y1 - p2 * y0) / dp_safe
    c2 = (y1 - p1 * y0) / -dp_safe

    is_cplx = params.p1i.abs() > 0
    # a complex-conjugate pair
    T0_c = 2.0 * c1 * dp / (p1_safe * p1_safe)
    W0_c = 2.0 * c1 / p1_safe
    # real distinct poles
    T0_r = c1 * dp / (p1_safe * p1_safe)
    W0_r = c2 / p2_safe + c1 / p1_safe
    # a repeated real pole p: y = (g0 + g1 n) p^n
    p = params.p1r
    prs = torch.where(p.abs() < tol, torch.ones_like(p), p)
    g1 = y1 / prs - y0
    T0_rep = (g1 / prs).to(p1.dtype)
    W0_rep = ((y0 - g1) / prs).to(p1.dtype)
    # p2 == 0 (a one-pole filter): w1 is 0 by structure, y decays as p1^n
    T0_z = (y0 / p1_safe).to(p1.dtype)

    near_rep = ~is_cplx & (dp.abs() < tol)
    T0 = torch.where(is_cplx, T0_c, torch.where(near_rep, T0_rep, T0_r))
    W0 = torch.where(is_cplx, W0_c, torch.where(near_rep, W0_rep, W0_r))
    p2_zero = p2.abs() < tol
    T0 = torch.where(p2_zero, T0_z, T0)
    W0 = torch.where(p2_zero, torch.zeros_like(W0), W0)
    all_zero = p1.abs() < tol
    T0 = torch.where(all_zero, torch.zeros_like(T0), T0)
    W0 = torch.where(all_zero, torch.zeros_like(W0), W0)
    z = torch.zeros_like(T0.real)
    return ModalState(x1=z, x2=z, tr=T0.real, ti=T0.imag,
                      wr=W0.real, wi=W0.imag)


# ---- the companion-form engines: per-sample coefficients -----------------------
#
# DF2T  y[n] = b0 x[n] + w0[n-1],  w0[n] = b1 x[n] - a1 y[n] + w1[n-1],
# w1[n] = b2 x[n] - a2 y[n]  is the affine recurrence  s[n] = A s[n-1] + B
# x[n]  on  s = [w0, w1]  with  A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0,
# b2 - a2 b0]  and  y[n] = b0 x[n] + s[n-1][0].  Every coefficient may
# change from sample to sample (a click-free retarget), where no pole
# factorization holds.

def biquad_ssm(coeffs: torch.Tensor):
    """``[..., 5]`` coefficients as the state-space form ``(A [..., 2, 2],
    B [..., 2], b0 [...])``."""
    b0, b1, b2, a1, a2 = coeffs.unbind(-1)
    A = torch.stack([torch.stack([-a1, torch.ones_like(a1)], -1),
                     torch.stack([-a2, torch.zeros_like(a1)], -1)], -2)
    return A, torch.stack([b1 - a1 * b0, b2 - a2 * b0], -1), b0


def _coef_planes(coeffs: torch.Tensor, time_varying: bool):
    """Five planes ``[..., T]`` (per-sample) or ``[..., 1]`` (static), time
    last, that broadcast from the right against ``x [..., T]``."""
    if time_varying:
        return coeffs.unbind(-1)
    return tuple(c[..., None] for c in coeffs.unbind(-1))


def _apply_scan(x, coeffs, state, time_varying: bool):
    """The sequential engine: the literal DF2T tick, one sample after the
    other, in a Python loop over T.  It is the correctness anchor, for
    tests and tiny blocks: a dozen launches a sample on a card."""
    planes = _coef_planes(coeffs, time_varying)
    batch = torch.broadcast_shapes(x.shape[:-1], planes[0].shape[:-1])
    w0 = state[..., 0].expand(batch)
    w1 = state[..., 1].expand(batch)
    ys = []
    for n in range(x.shape[-1]):
        b0, b1, b2, a1, a2 = (p[..., n if time_varying else 0]
                              for p in planes)
        xn = x[..., n]
        y = b0 * xn + w0
        w0, w1 = b1 * xn - a1 * y + w1, b2 * xn - a2 * y
        ys.append(y)
    return torch.stack(ys, -1), torch.stack([w0, w1], -1)


def _scan_maps(E: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of affine 2 x 2 maps along the last axis.

    ``E [2, 3, ..., T]`` holds a map a sample as the top two rows of ``[[A,
    v], [0, 1]]``: ``E[i, k]`` is ``A[i, k]`` for ``k < 2`` and ``v[i]`` for
    ``k = 2``.  Out comes, for every ``n``, the map of samples ``0 .. n``
    composed, ``(A, v) <- (A_n A_before, A_n v_before + v_n)``.

    Hillis-Steele doubling: log2(T) passes ``E[n] <- E[n] o E[n - d]``, all
    six planes at once, three launches a pass.  The passes ping-pong
    between two buffers that hold ``Z`` identity maps (the largest stride)
    before the ``T`` samples, so the element ``d`` before sample ``n < d``
    is the identity."""
    T = E.shape[-1]
    strides, _ = _doubling_strides(T, E.device)
    if not strides:
        return E
    Z = strides[-1]
    bufs = [E.new_zeros(E.shape[:-1] + (Z + T,)) for _ in range(2)]
    for b in bufs:
        b[0, 0, ..., :Z] = 1.0
        b[1, 1, ..., :Z] = 1.0
    tails = [b.narrow(-1, Z, T) for b in bufs]
    tails[0].copy_(E)
    for k, d in enumerate(strides):
        g, out = tails[k % 2], tails[1 - k % 2]
        f = bufs[k % 2].narrow(-1, Z - d, T)
        # out[i, k] = g[i, 0] f[0, k] + g[i, 1] f[1, k] (+ g[i, 2], k = 2)
        torch.mul(g[:, 0, None], f[None, 0], out=out)
        out.addcmul_(g[:, 1, None], f[None, 1])
        out[:, 2].add_(g[:, 2])
    return tails[len(strides) % 2]


def _apply_assoc(x, coeffs, state, time_varying: bool, dtype, chunk=None):
    """The parallel engine: the scan of the affine maps, computed in
    ``dtype`` and rounded to ``x``'s.

    One flat scan over T.  ``chunk = K`` takes the JAX package's two levels
    instead (scans within chunks of K samples, then a scan of the chunks'
    whole maps, by doubling too, for the state that enters each chunk).
    No engine asks for them: in float32 they gain 0 to 2 dB against
    float64 at K = 128 and nothing in float64, for more launches; the
    tests keep that comparison."""
    T = x.shape[-1]
    b0, b1, b2, a1, a2 = (p.to(dtype) for p in
                          _coef_planes(coeffs, time_varying))
    xd = x.to(dtype)
    v1 = (b1 - a1 * b0) * xd
    v2 = (b2 - a2 * b0) * xd
    full = v1.shape
    batch = full[:-1]
    K = T if chunk is None else min(chunk, T)
    nc = -(-T // K)
    E = x.new_zeros((2, 3) + batch + (nc * K,), dtype=dtype)
    # beyond T the identity: A = I, v = 0
    E[0, 0, ..., T:] = 1.0
    E[1, 1, ..., T:] = 1.0
    E[0, 0, ..., :T] = -a1
    E[0, 1, ..., :T] = 1.0
    E[1, 0, ..., :T] = -a2
    E[0, 2, ..., :T] = v1
    E[1, 2, ..., :T] = v2
    s0 = torch.stack([state[..., 0].expand(batch),
                      state[..., 1].expand(batch)]).to(dtype)   # [2, ...]
    M = _scan_maps(E.reshape((2, 3) + batch + (nc, K)))
    if nc > 1:
        # the state that enters chunk m: the chunks' maps composed up to
        # m - 1, applied to s0
        tot = _scan_maps(M[..., -1])                          # [2, 3, .., nc]
        into = tot[:, 0] * s0[0, ..., None] + tot[:, 1] * s0[1, ..., None] \
            + tot[:, 2]
        sin = torch.cat([s0[..., None], into[..., :-1]], -1)   # [2, .., nc]
    else:
        sin = s0[..., None]
    s = M[:, 0] * sin[0, ..., None] + M[:, 1] * sin[1, ..., None] + M[:, 2]
    s = s.reshape((2,) + batch + (nc * K,))
    w0_prev = torch.cat([s0[0, ..., None], s[0, ..., :T - 1]], -1)
    y = b0 * xd + w0_prev
    return y.to(x.dtype), s[..., T - 1].movedim(0, -1).to(x.dtype)


def _coeff_tensor(coeffs, device) -> torch.Tensor:
    """Coefficients as a tensor on ``device``; host values keep float64."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.to(device)
    return torch.from_numpy(np.array(coeffs, np.float64)).to(device)


def biquad_apply(x: torch.Tensor, coeffs, state=None, engine: str = "auto"):
    """One biquad over ``x [..., T]`` (float32 or float64): ``(y,
    state')``.

    ``coeffs`` is ``[..., 5]`` (static), ``[..., T, 5]`` (one set a sample,
    as :func:`interp_trajectory` makes them) or a :class:`ModalParams`.
    ``engine``:

    * ``"auto"``: modal for static coefficients given on the host (numpy,
      a list: the float64 design, whose poles are found on the host); the
      companion scan ``"assoc"`` for a trajectory, and for static
      coefficients that are already a tensor;
    * ``"modal"``: the pole-factored engine (static coefficients only);
    * ``"assoc"``: the companion scan in ``x``'s dtype;
    * ``"assoc_dw"``: the companion scan in float64 on the trajectory as
      given (pass it in float64), the output rounded to ``x``'s dtype.  The name is the JAX package's, whose engine carries
      pairs of float32 because its device has no float64; here the card
      has, and float64 meets the same bar (poles within 1e-4 of the unit
      circle at >= 130 dB against a float64 per-sample loop);
    * ``"scan"``: the sequential DF2T tick, the correctness anchor.

    The state is ``[..., 2]`` DF2T registers in ``x``'s dtype for the
    companion engines and a :class:`ModalState` for modal: pass back what
    came out."""
    if isinstance(coeffs, ModalParams):
        if engine not in ("auto", "modal"):
            raise ValueError("ModalParams requires the modal engine")
        return modal_apply(x, coeffs, state)
    shape = tuple(np.shape(coeffs))
    time_varying = len(shape) == x.dim() + 1 and shape[-2] == x.shape[-1]
    if engine == "auto":
        host_given = not isinstance(coeffs, torch.Tensor)
        engine = "modal" if host_given and not time_varying else "assoc"
    if engine == "modal":
        if time_varying:
            raise ValueError("modal engine requires time-invariant coeffs")
        host = (coeffs.detach().cpu().numpy()
                if isinstance(coeffs, torch.Tensor) else coeffs)
        return modal_apply(x, modal_params(host, device=x.device,
                                           dtype=x.dtype), state)
    if engine not in ("assoc", "assoc_dw", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "assoc_dw" and not time_varying:
        raise ValueError("assoc_dw requires a [..., T, 5] trajectory")
    c = _coeff_tensor(coeffs, x.device)
    if state is None:
        batch = torch.broadcast_shapes(
            x.shape[:-1], c.shape[:-2] if time_varying else c.shape[:-1])
        state = x.new_zeros(batch + (2,))
    if engine == "assoc_dw":
        return _apply_assoc(x, c, state, True, torch.float64)
    if engine == "assoc":
        return _apply_assoc(x, c, state, time_varying, x.dtype)
    return _apply_scan(x, c.to(x.dtype), state, time_varying)


def cascade_apply(x: torch.Tensor, coeffs, states=None, engine: str = "auto",
                  systolic: bool = False):
    """A serial biquad cascade: the stages ``coeffs [S, ..., 5]`` (or a
    :class:`ModalParams` with S leading) one after the other: ``(y,
    states')``, a list of one state a stage.

    ``engine="parallel"`` (or a :class:`ParallelCascadeParams`) runs the
    whole static cascade in its partial-fraction form as one batched scan;
    it raises ``ValueError`` where that form is ill-conditioned.

    ``systolic=True`` gives every stage the previous output of the stage
    before it: the serial cascade with one sample of delay between stages,
    the output ``S - 1`` samples late."""
    if engine == "parallel" or isinstance(coeffs, ParallelCascadeParams):
        if systolic:
            raise ValueError("systolic mode is a serial-form semantic")
        params = (coeffs if isinstance(coeffs, ParallelCascadeParams)
                  else parallel_cascade_params(coeffs, x.dtype,
                                               device=x.device))
        return parallel_cascade_apply(x, params, states)
    modal = isinstance(coeffs, ModalParams)
    S = coeffs.b0.shape[0] if modal else np.shape(coeffs)[0]
    if states is None:
        states = [None] * S
    y, new_states = x, []
    for i in range(S):
        if systolic and i > 0:
            y = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], -1)
        ci = ModalParams(*(f[i] for f in coeffs)) if modal else coeffs[i]
        y, s = biquad_apply(y, ci, states[i], engine=engine)
        new_states.append(s)
    return y, new_states


def interp_trajectory(current, targets, mul, dec, nframes: int, *, device):
    """The coefficients of every sample of one block under the shared
    interpolation controller: ``(coeffs [..., nframes, 5], mul')`` on
    ``device``, in ``targets``' dtype (float64 for host values).

    ``diffs = targets - current``, with ``current`` the coefficients when
    the target was set; sample ``n`` uses ``targets - mul_n diffs`` with
    ``mul_0 = mul`` (the value entering the block) and ``mul_{n+1} =
    max(mul_n - dec, 0)``: one scalar drives all five coefficients, so they
    land together, and the step comes after each processed sample."""
    targets = _coeff_tensor(targets, device)
    kw = {"dtype": targets.dtype, "device": targets.device}
    diffs = targets - _coeff_tensor(current, device).to(targets.dtype)
    mul, dec = torch.as_tensor(mul, **kw), torch.as_tensor(dec, **kw)
    n = torch.arange(nframes, **kw)
    muls = torch.clamp(mul - dec * n, min=0.0)
    coeffs = targets[..., None, :] - muls[:, None] * diffs[..., None, :]
    return coeffs, torch.clamp(mul - dec * nframes, min=0.0)
