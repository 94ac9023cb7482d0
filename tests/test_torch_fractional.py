"""The port's fractional delay reads and resampler against the JAX
package and the float64 golden.

The same numpy rings and float32 positions go through both packages on
the CPU.  Phase and base come from ``floor`` of a float32 position, so the
positions are handed to both as float32 and include exact phase boundaries
(``k / 128``), the ring's wrap and its first and last samples: a phase
picked differently would cost far more than any tolerance here.  Against
JAX the reads are held at >= 120 dB (the same float32 products, summed in
another order); against ``golden.fractional.fractional_delay_block``
(float64 sums of the same table) at >= 90 dB.  The two packages' copies of
the q23 table are held byte for byte.
"""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bbcat_dsp_torch.filters.fractional as tfrac
import bbcat_dsp_tpu.filters
from bbcat_dsp_tpu.filters import fractional as jfrac
from bbcat_dsp_tpu.golden import fractional as gfrac
from bbcat_dsp_torch.filters import (
    FractionalDelayLine,
    Resampler,
    fractional_read,
    fractional_read_stream,
    resample,
)
from conftest import snr_db

# the package's ``resample`` function shadows the module of the same name
jresample = importlib.import_module("bbcat_dsp_tpu.filters.resample")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positions(rng, C, n, L):
    """Float32 positions ``[C, n]`` in ``[0, L)``: random ones, exact phase
    boundaries, integers, and the ring's two ends."""
    pos = rng.uniform(0.0, L, (C, n)).astype(np.float32)
    k = rng.integers(0, L * 128, (C, n // 4))
    pos[:, :n // 4] = (k / 128.0).astype(np.float32)      # on a boundary
    pos[:, n // 4] = 0.0
    pos[:, n // 4 + 1] = np.float32(L) - np.float32(1.0 / 128)
    pos[:, n // 4 + 2] = 13.0                              # base wraps to L - 1
    pos[:, n // 4 + 3] = 14.0                              # base 0
    pos[:, n // 4 + 4] = np.nextafter(np.float32(20), np.float32(0))
    return pos


def test_the_two_tables_are_the_same_bytes():
    theirs = Path(bbcat_dsp_tpu.filters.__file__).parent / "data" / \
        "polyphase_sinc_14x128_q23.npy"
    assert tfrac._TABLE_FILE.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(tfrac.polyphase_table(),
                                  gfrac.polyphase_table())
    assert (tfrac.OVERSAMPLING, tfrac.TAPS, tfrac.ADDITIONAL_DELAY) == (
        gfrac.OVERSAMPLING, gfrac.TAPS, gfrac.ADDITIONAL_DELAY)
    assert tfrac.additional_delay_required() == 14


@pytest.mark.parametrize("C,L,n", [(3, 64, 96), (2, 37, 64), (1, 256, 200)])
def test_fractional_read_matches_jax_and_golden(rng, C, L, n):
    buf = rng.standard_normal((C, L)).astype(np.float32)
    pos = _positions(rng, C, n, L)
    want = np.asarray(jfrac.fractional_read(jnp.asarray(buf), jnp.asarray(pos)))
    got = fractional_read(torch.from_numpy(buf), torch.from_numpy(pos)).numpy()
    assert got.shape == (C, n) and got.dtype == np.float32
    assert snr_db(want, got) >= 120.0
    # sample by sample: no position took another phase or base
    assert np.abs(want - got).max() <= 1e-5
    gold = gfrac.fractional_delay_block(buf, pos, L)
    assert snr_db(gold, got) >= 90.0


def test_fractional_read_broadcasts_positions_over_channels(rng):
    buf = rng.standard_normal((3, 48)).astype(np.float32)
    pos = _positions(rng, 1, 40, 48)[0]
    want = np.asarray(jfrac.fractional_read(
        jnp.asarray(buf), jnp.asarray(np.broadcast_to(pos, (3, 40)))))
    got = fractional_read(torch.from_numpy(buf), torch.from_numpy(pos)).numpy()
    assert got.shape == (3, 40)
    assert snr_db(want, got) >= 120.0


@pytest.mark.parametrize("C,L,out_len", [(3, 64, 40), (4, 128, 128),
                                         (2, 37, 30)])
def test_fractional_read_stream_matches_jax_read_and_golden(rng, C, L,
                                                            out_len):
    buf = rng.standard_normal((C, L)).astype(np.float32)
    # starts near the wrap, on a phase boundary, at 0 and mid-ring
    start = rng.uniform(0.0, L, C).astype(np.float32)
    start[0] = np.float32(L - 3) + np.float32(77.0 / 128)
    start[-1] = np.float32(5.0 / 128)
    want = np.asarray(jfrac.fractional_read_stream(
        jnp.asarray(buf), jnp.asarray(start), out_len))
    tb, ts = torch.from_numpy(buf), torch.from_numpy(start)
    got = fractional_read_stream(tb, ts, out_len).numpy()
    assert got.shape == (C, out_len)
    assert snr_db(want, got) >= 120.0
    assert np.array_equal(got, fractional_read_stream(
        tb, ts, out_len=out_len).numpy())
    # the same as the gather read at positions one sample apart (exact in
    # float32: start has 7 fraction bits and L is small)
    pos = (start[:, None] + np.arange(out_len, dtype=np.float32)) % np.float32(L)
    read = fractional_read(tb, torch.from_numpy(pos.astype(np.float32))).numpy()
    assert snr_db(read, got) >= 120.0
    gold = gfrac.fractional_delay_block(buf, pos, L)
    assert snr_db(gold, got) >= 90.0


def test_fractional_delay_line_matches_jax(rng):
    C, L, B = 3, 64, 24
    jl = jfrac.FractionalDelayLine(C, L)
    tl = FractionalDelayLine(C, L, device="cpu")
    for _ in range(5):                         # 120 samples: wraps once
        blk = rng.standard_normal((C, B)).astype(np.float32)
        # delays on a grid float32 holds exactly next to the write position
        delays = (rng.integers(0, (L - 14) * 128, (C, 16)) / 128.0
                  + 1.0 / 256).astype(np.float32)
        jl.write(jnp.asarray(blk))
        tl.write(torch.from_numpy(blk))
        assert tl.writepos == jl.writepos
        np.testing.assert_array_equal(np.asarray(jl.buf), tl.buf.numpy())
        want = np.asarray(jl.read(jnp.asarray(delays)))
        got = tl.read(delays).numpy()
        assert snr_db(want, got) >= 120.0
        assert np.abs(want - got).max() <= 1e-5


def test_resample_matches_jax_and_the_closed_form():
    fs, ratio = 48000.0, 2.0
    t = np.arange(4096) / fs
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    want = np.asarray(jresample.resample(jnp.asarray(x[None]), ratio))[0]
    y = resample(torch.from_numpy(x[None]), ratio)[0].numpy()
    assert y.shape == want.shape
    assert snr_db(want, y) >= 120.0
    # the check of tests/test_filters.py: output k reads input position
    # k / ratio + 14, and the table's effective group delay is 8 samples
    n = y.size
    tt = (np.arange(n) / ratio + tfrac.ADDITIONAL_DELAY - 8.0) / fs
    m = slice(100, n - 100)
    assert snr_db(np.sin(2 * np.pi * 1000.0 * tt)[m], y[m]) > 55.0


@pytest.mark.parametrize("ratio,n_out", [(0.9173, None), (1.5, 300),
                                         (44100.0 / 48000.0, None)])
def test_resample_picks_jax_positions(rng, ratio, n_out):
    x = rng.standard_normal((2, 700)).astype(np.float32)
    want = np.asarray(jresample.resample(jnp.asarray(x), ratio, n_out))
    got = resample(torch.from_numpy(x), ratio, n_out).numpy()
    assert got.shape == want.shape
    assert snr_db(want, got) >= 120.0
    assert np.abs(want - got).max() <= 1e-5


def test_resampler_streaming_matches_jax_and_oneshot(rng):
    C, B, nblk, ratio = 2, 256, 6, 0.9173
    x = rng.standard_normal((C, B * nblk)).astype(np.float32)
    jr = jresample.Resampler(C, ratio, B)
    tr = Resampler(C, ratio, B, device="cpu")
    outs = []
    for i in range(nblk):
        blk = x[:, i * B:(i + 1) * B]
        want = np.asarray(jr.process(jnp.asarray(blk)))
        got = tr.process(torch.from_numpy(blk)).numpy()
        assert got.shape == want.shape          # the same sample count
        assert snr_db(want, got) >= 120.0
        outs.append(got)
    y_stream = np.concatenate(outs, -1)
    # one-shot over the zero-history-padded stream, as the JAX package's
    # own test: isolated phase flips where the two paths round positions
    # at different offsets, agreement everywhere else
    hist = np.zeros((C, tfrac.ADDITIONAL_DELAY + B), np.float32)
    full = np.concatenate([hist, x], -1)
    n = y_stream.shape[-1]
    pos = (np.arange(n) / ratio + hist.shape[-1]).astype(np.float32)
    y_ref = fractional_read(torch.from_numpy(full),
                            torch.from_numpy(pos)).numpy()
    assert y_stream.shape == y_ref.shape
    assert np.mean(np.abs(y_stream - y_ref) > 1e-4) < 0.02
    assert snr_db(y_ref, y_stream) > 30.0


def test_resampler_emits_nothing_until_a_sample_is_due():
    r = Resampler(2, 0.01, 8, device="cpu")     # one output per 100 inputs
    counts = [r.process(torch.ones(2, 8)).shape[-1] for _ in range(14)]
    assert sum(counts) == int(np.floor(14 * 8 * 0.01 + 1e-9)) == 1
    assert counts[-2:] == [1, 0] or counts.count(1) == 1
