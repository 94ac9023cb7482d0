"""The port's ``offline_convolve`` against the JAX package, the golden
direct convolution and the port's streaming engine.

The same numpy inputs go through both packages on the CPU.  >= 90 dB
against the float64 direct convolution (``tests/test_convolve.py``'s bar);
>= 100 dB against the JAX package, whose large transforms are matrix
products at highest precision where the port's are ``torch.fft`` (two
float32 FFTs of different structure); >= 100 dB against the streaming
``BlockConvolver`` of the same package, as ``test_offline_matches_
streaming_engine`` asks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import offline as joffline
from bbcat_dsp_torch import BlockConvolver, offline_convolve
from conftest import snr_db


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C,N,T,n_fft", [
    (1, 400, 5000, 4096),      # two chunks
    (3, 1000, 12000, 4096),    # four chunks
    (2, 64, 700, 4096),        # one chunk
    (2, 300, 9000, None),      # the default size: 4096
    (2, 100, 1000, 256),       # many small chunks
])
def test_offline_convolve_vs_golden_and_jax(rng, C, N, T, n_fft):
    irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / (N / 4))
    x = rng.standard_normal((C, T)).astype(np.float32)
    y = offline_convolve(torch.from_numpy(x), irs, n_fft=n_fft)
    jy = np.asarray(joffline.offline_convolve(jnp.asarray(x), irs,
                                              n_fft=n_fft))
    assert y.shape == (C, T) and y.dtype == torch.float32
    for c in range(C):
        ref = golden.direct_convolve(x[c].astype(np.float64), irs[c])[:T]
        assert snr_db(ref, y[c].numpy()) > 90.0, c
    assert snr_db(jy, y.numpy()) >= 100.0


def test_one_dimensional_signal_and_a_shared_ir(rng):
    ir = rng.standard_normal(200) * 0.1
    x = rng.standard_normal((3, 3000)).astype(np.float32)
    y = offline_convolve(torch.from_numpy(x), ir)          # one IR for all
    y0 = offline_convolve(torch.from_numpy(x[0]), ir)      # [T] in, [T] out
    assert y.shape == (3, 3000) and y0.shape == (3000,)
    ref = golden.direct_convolve(x[0].astype(np.float64), ir)[:3000]
    assert snr_db(ref, y0.numpy()) > 90.0
    assert snr_db(y[0].numpy(), y0.numpy()) > 130.0
    jy = np.asarray(joffline.offline_convolve(jnp.asarray(x), ir))
    assert snr_db(jy, y.numpy()) >= 100.0


def test_too_small_a_transform_is_refused():
    x = torch.zeros(1, 100)
    with pytest.raises(ValueError, match="too small"):
        offline_convolve(x, np.ones(300), n_fft=512)
    with pytest.raises(ValueError, match="too small"):
        joffline.offline_convolve(jnp.zeros((1, 100)), np.ones(300), n_fft=512)


def test_offline_matches_the_streaming_engine(rng):
    B, N, T = 128, 1024, 128 * 10
    ir = rng.standard_normal((2, N)) * 0.2
    x = torch.from_numpy(rng.standard_normal((2, T)).astype(np.float32))
    ys = BlockConvolver(ir, block=B, device="cpu").process(x)
    yo = offline_convolve(x, ir)
    assert snr_db(ys.numpy(), yo.numpy()) > 100.0
