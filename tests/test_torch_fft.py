"""The port's spectral core against ``bbcat_dsp_tpu.convolve.fft``.

The reference runs its ``xla`` backend (``jnp.fft``, standard layout), the
backend it resolves on the CPU; the port runs ``torch.fft``.  The two FFT
libraries agree to ~135-140 dB in float32, so 110 dB is the bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.convolve import fft as jfft
from bbcat_dsp_torch.convolve import fft as tfft
from conftest import snr_db


@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_rfft_half_planes_matches_jax(rng, n):
    x = rng.standard_normal((3, 5, n // 2)).astype(np.float32)
    want = np.asarray(jfft.rfft_half_planes(jnp.asarray(x), n, backend="xla"))
    got = tfft.rfft_half_planes(torch.from_numpy(x), n).numpy()
    assert got.shape == want.shape == (2, 3, 5, n // 2 + 1)
    assert snr_db(want, got) >= 110.0


@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_irfft_tail_planes_matches_jax(rng, n):
    # random planes: the DC and Nyquist imaginary parts are nonzero, and
    # both sides must drop them
    planes = rng.standard_normal((2, 4, n // 2 + 1)).astype(np.float32)
    want = np.asarray(
        jfft.irfft_tail_planes(jnp.asarray(planes), n, backend="xla"))
    got = tfft.irfft_tail_planes(torch.from_numpy(planes), n).numpy()
    assert got.shape == want.shape == (4, n // 2)
    assert snr_db(want, got) >= 110.0


@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_signs_and_bins_match_jax(n):
    got = tfft.half_window_signs(n, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), jfft.half_window_signs(n, backend="xla"))
    assert tfft.spectral_nbins(n) == jfft.spectral_nbins(n, backend="xla")


def test_half_window_shift_theorem(rng):
    """The window spectrum assembles from two half-window spectra:
    ``rfft([a, b]) = Xh(a) + (-1)^k Xh(b)``."""
    n = 256
    a, b = rng.standard_normal((2, n // 2)).astype(np.float32)
    Xa = tfft.rfft_half_planes(torch.from_numpy(a), n)
    Xb = tfft.rfft_half_planes(torch.from_numpy(b), n)
    W = Xa + tfft.half_window_signs(n, "cpu") * Xb
    ref = np.fft.rfft(np.concatenate([a, b]).astype(np.float64))
    assert snr_db(np.stack([ref.real, ref.imag]), W.numpy()) >= 120.0
    # and the tail-only inverse returns the window's second half
    y = tfft.irfft_tail_planes(W, n).numpy()
    np.testing.assert_allclose(y, b, atol=1e-5)
