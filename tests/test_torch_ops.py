"""The port's small device-side ops against the JAX package's.

Interpolator ramps and mixing to 1e-6 (the same float32 arithmetic; XLA
may contract a product and a sum where PyTorch does not), ``convolve2d``
to a relative 1e-5 of the output's peak against JAX and scipy (float32
sums in other orders), and the precision helper that keeps cuDNN's
convolutions off TF32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d as sp_convolve2d

from bbcat_dsp_tpu import ops as jops
from bbcat_dsp_torch import ops
from bbcat_dsp_torch.utils.interop import (
    complex_interpolator_from_jax,
    interpolator_from_jax,
)
from bbcat_dsp_torch.utils.precision import full_f32

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("cur,tgt,inc,n", [
    (0.0, 1.0, 0.05, 32),        # rising, lands at frame 20
    (1.0, -0.5, 0.1, 12),        # falling, lands at frame 15 (not here)
    (0.25, 0.25, 0.3, 5),        # at the target
    (0.0, 1.0, -0.2, 9),         # a negative increment counts by size
    (2.0, 0.0, 0.125, 20),       # falling, lands at frame 16
])
def test_interp_ramp_matches_jax(cur, tgt, inc, n):
    it = ops.interpolator(cur, tgt, device="cpu")
    jit = jops.interpolator(cur, tgt)
    for _ in range(3):                       # the ramp continues its state
        ramp, it = ops.interp_ramp(it, inc, n)
        jramp, jit = jops.interp_ramp(jit, inc, n)
        _close(ramp, jramp)
        _close(it.current, jit.current)
        assert bool(it.at_target.all()) == bool(np.asarray(jit.at_target).all())
        assert bool(it.nonzero.any()) == bool(np.asarray(jit.nonzero).any())


@pytest.mark.parametrize("vals,tgts,dec,n", [
    ([0.0, 10.0], [1.0, 20.0], 0.25, 6),
    ([[1.0, -2.0], [0.5, 0.0]], [[0.0, 2.0], [1.5, -1.0]], 0.01, 64),
    (3.0, -3.0, 0.3, 4),
])
def test_complex_interpolator_matches_jax(vals, tgts, dec, n):
    ci = ops.complex_interpolator(vals, tgts, device="cpu")
    jci = jops.complex_interpolator(vals, tgts)
    for _ in range(3):
        v, ci = ops.complex_interp_ramp(ci, dec, n)
        jv, jci = jops.complex_interp_ramp(jci, dec, n)
        assert v.shape == jv.shape
        _close(v, jv)
        _close(ci.controller, jci.controller)


def test_interpolators_started_in_jax_continue_in_the_port():
    _, jit = jops.interp_ramp(jops.interpolator(0.0, 1.0), 0.01, 30)
    it = interpolator_from_jax(jit, device="cpu")
    _, jci = jops.complex_interp_ramp(
        jops.complex_interpolator([0.0, 4.0], [1.0, -4.0]), 0.02, 10)
    ci = complex_interpolator_from_jax(jci, device="cpu")
    for _ in range(2):
        r, it = ops.interp_ramp(it, 0.01, 50)
        jr, jit = jops.interp_ramp(jit, 0.01, 50)
        _close(r, jr)
        v, ci = ops.complex_interp_ramp(ci, 0.02, 40)
        jv, jci = jops.complex_interp_ramp(jci, 0.02, 40)
        _close(v, jv)


@pytest.mark.parametrize("mul,sc,dc,n", [
    (0.5, 1, 2, 2), (1.0, 0, 0, None), (-0.3, 2, 0, 5), (0.7, 3, 3, 4),
    (0.0, 0, 0, None), (2.0, 4, 0, 3),
])
def test_mix_samples_matches_jax(rng, mul, sc, dc, n):
    dst = rng.standard_normal((4, 16)).astype(np.float32)
    src = rng.standard_normal((5, 20)).astype(np.float32)
    dst_t = torch.from_numpy(dst.copy())
    got = ops.mix_samples(dst_t, torch.from_numpy(src), mul, sc, dc, n)
    want = jops.mix_samples(jnp.asarray(dst), jnp.asarray(src), mul, sc, dc, n)
    _close(got, want)
    np.testing.assert_array_equal(dst_t.numpy(), dst)   # dst left as it was


def test_mix_samples_with_zero_mul_returns_dst_untouched(rng):
    dst = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    src = torch.full((2, 8), float("nan"))
    assert ops.mix_samples(dst, src, 0.0) is dst        # nothing computed
    assert ops.mix_samples(dst, src, 0) is dst
    assert torch.isnan(ops.mix_samples(dst, src, torch.tensor(0.0))).all()


@pytest.mark.parametrize("cur,tgt,inc,sc,dc,n", [
    (0.0, 1.0, 0.05, 0, 0, None), (1.0, 0.0, 0.02, 1, 0, 2),
    (0.5, 0.5, 0.1, 0, 1, 3), (0.2, 0.9, 0.3, 2, 2, 2),
])
def test_mix_samples_ramped_matches_jax(rng, cur, tgt, inc, sc, dc, n):
    dst = rng.standard_normal((4, 40)).astype(np.float32)
    src = rng.standard_normal((4, 48)).astype(np.float32)
    it = ops.interpolator(cur, tgt, device="cpu")
    jit = jops.interpolator(cur, tgt)
    for _ in range(2):
        got, it = ops.mix_samples_ramped(torch.from_numpy(dst),
                                         torch.from_numpy(src), it, inc, sc,
                                         dc, n)
        want, jit = jops.mix_samples_ramped(jnp.asarray(dst), jnp.asarray(src),
                                            jit, inc, sc, dc, n)
        _close(got, want)
        _close(it.current, jit.current)


def test_mix_samples_ramped_matches_the_scalar_loop(rng):
    """``test_buffers_ops.py``'s per-frame loop, in float64."""
    src = rng.standard_normal((1, 32)).astype(np.float32)
    dst, it = ops.mix_samples_ramped(torch.zeros((1, 32)),
                                     torch.from_numpy(src),
                                     ops.interpolator(0.0, 1.0, device="cpu"),
                                     0.05)
    cur, ref = 0.0, np.zeros(32)
    for i in range(32):
        ref[i] = cur * src[0, i]
        cur = min(cur + 0.05, 1.0)
    _close(dst[0], ref)
    assert abs(float(it.current) - cur) < TOL


def _conv2d_all(rng, img_shape, k_shape, mode):
    """The port's, the JAX package's and scipy's (float64) outputs."""
    img = rng.standard_normal(img_shape).astype(np.float32)
    k = rng.standard_normal(k_shape).astype(np.float32)
    got = ops.convolve2d(torch.from_numpy(img), torch.from_numpy(k), mode)
    want = np.asarray(jops.convolve2d(jnp.asarray(img), jnp.asarray(k), mode))
    flat = img.reshape((-1,) + img_shape[-2:]).astype(np.float64)
    ref = np.stack([sp_convolve2d(im, k.astype(np.float64), mode=mode)
                    for im in flat]).reshape(want.shape)
    assert got.shape == want.shape and got.dtype == torch.float32
    return got.numpy(), want, ref


def _rel_close(a, b, ref):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["same", "valid", "full"])
@pytest.mark.parametrize("img_shape,k_shape", [
    ((9, 11), (3, 5)), ((2, 16, 13), (5, 5)), ((3, 2, 12, 12), (7, 1)),
    ((8, 8), (1, 1)), ((20, 7), (3, 3)),
])
def test_convolve2d_matches_jax_and_scipy(rng, mode, img_shape, k_shape):
    got, want, ref = _conv2d_all(rng, img_shape, k_shape, mode)
    _rel_close(got, want, ref)
    _rel_close(got, ref, ref)


@pytest.mark.parametrize("mode", ["valid", "full"])
@pytest.mark.parametrize("img_shape,k_shape", [
    ((2, 16, 13), (4, 4)), ((3, 2, 12, 12), (5, 2)), ((20, 7), (6, 3)),
])
def test_convolve2d_with_even_kernels_matches_jax_and_scipy(rng, mode,
                                                           img_shape, k_shape):
    got, want, ref = _conv2d_all(rng, img_shape, k_shape, mode)
    _rel_close(got, want, ref)
    _rel_close(got, ref, ref)


@pytest.mark.parametrize("img_shape,k_shape,shift", [
    ((2, 16, 13), (4, 4), (1, 1)), ((3, 2, 12, 12), (5, 2), (0, 1)),
    ((20, 7), (6, 3), (1, 0)),
])
def test_same_with_an_even_kernel_is_scipys_in_the_port_and_shifted_in_jax(
        rng, img_shape, k_shape, shift):
    """A reference fault: the JAX package's "same" pads ``(k - 1) // 2``
    before and ``k // 2`` after, so with an even kernel size its output is
    scipy's moved one sample along that axis.  The port takes scipy's
    centre; JAX's output is the port's one sample later."""
    state = rng.bit_generator.state
    got, want, ref = _conv2d_all(rng, img_shape, k_shape, "same")
    _rel_close(got, ref, ref)
    assert np.abs(want - ref).max() > 0.1 * np.abs(ref).max()
    rng.bit_generator.state = state          # the same image and kernel
    full = _conv2d_all(rng, img_shape, k_shape, "full")[0]
    H, W = img_shape[-2:]
    a, b = (k_shape[0] - 1) // 2 + shift[0], (k_shape[1] - 1) // 2 + shift[1]
    _rel_close(want, full[..., a:a + H, b:b + W], ref)


def test_convolve2d_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        ops.convolve2d(torch.zeros(4, 4), torch.ones(2, 2), "circular")


def test_full_f32_sets_and_restores_matmul_and_cudnn_flags():
    """Inside the helper both cuBLAS and cuDNN's convolutions are IEEE
    float32; after it the caller's settings are back, set through either
    API."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    before = (conv.fp32_precision, mm.fp32_precision)
    try:
        conv.fp32_precision = "tf32"
        mm.fp32_precision = "tf32"
        with full_f32():
            assert (conv.fp32_precision, mm.fp32_precision) == ("ieee", "ieee")
        assert (conv.fp32_precision, mm.fp32_precision) == ("tf32", "tf32")
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            assert conv.fp32_precision == "ieee"
        assert torch.backends.cudnn.allow_tf32
    finally:
        conv.fp32_precision, mm.fp32_precision = before
