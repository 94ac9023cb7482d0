"""The plain reference against a direct float64 convolution on a tiny
case, and the control's TF32 rounding."""

import numpy as np
import pytest
import torch

from cardbench.reference import nonuniform as ref


def _direct(x, h):
    return np.stack([np.convolve(a, b)[:x.shape[1]] for a, b in zip(x, h)])


@pytest.mark.parametrize("C, N, L, n_out", [(3, 37, 200, 50), (2, 64, 64, 64),
                                            (5, 9, 9, 1), (130, 16, 40, 40)])
def test_the_reference_is_the_direct_convolution(C, N, L, n_out):
    rng = np.random.default_rng(C * 1000 + N)
    x = rng.standard_normal((C, L)).astype(np.float32)
    h = rng.standard_normal((C, N)).astype(np.float32)
    got = ref.outputs(torch.from_numpy(x), torch.from_numpy(h), n_out)
    want = _direct(x.astype(np.float64), h.astype(np.float64))[:, L - n_out:]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_tf32_keeps_ten_bits_of_mantissa_rounded_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20,
                      1.0 + 2 ** -12, -3.0 - 2 ** -9 - 2 ** -12])
    got = ref.tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -3.0 - 2 ** -9])
    assert torch.equal(got, want)
    r = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    rel = ((ref.tf32(r) - r).abs() / r.abs()).max()
    assert 2 ** -13 < rel <= 2 ** -11


def test_the_control_reads_far_above_the_float32_engine_and_the_limit():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 3000, generator=g)
    h = torch.randn(4, 700, generator=g) * torch.exp(-torch.arange(700) / 150)
    exact = ref.outputs(x, h, 1000)
    ctl = ref.outputs(x, h, 1000, precision="tf32")
    err = float(((ctl - exact).norm(dim=1) / exact.norm(dim=1)).max())
    assert err > 10 ** (-90 / 20) * 3
    with pytest.raises(ValueError):
        ref.outputs(x, h, 10, precision="bfloat16")
