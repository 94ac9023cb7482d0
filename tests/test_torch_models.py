"""The port's binaural renderer and mixdown pipeline against the JAX
package.

The same numpy inputs go through both packages' models on the CPU.  The
binaural output is held at >= 100 dB against JAX (its EQ and HRTF
exchange included) and at >= 90 dB against a float64 chain of golden
models; its meter's readouts within 0.01 LU of JAX's.  The mixdown output
is held at >= 110 dB as float, and the int32 conversions bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.formats import device as jdevice
from bbcat_dsp_tpu.formats.sample_format import SampleFormat as JaxFormat
from bbcat_dsp_tpu.models import BinauralRenderer as JaxBinauralRenderer
from bbcat_dsp_tpu.models import MixdownPipeline as JaxMixdownPipeline
from bbcat_dsp_torch import BinauralRenderer, MixdownPipeline
from bbcat_dsp_torch.filters import FilterType, biquad_coeffs
from bbcat_dsp_torch.formats import (
    SampleFormat,
    float_to_int32,
    int32_to_float,
    is_sample_integer,
)
from bbcat_dsp_torch.models import binaural as tbinaural
from bbcat_dsp_torch.utils.interop import binaural_state_from_jax
from conftest import snr_db
from test_torch_iir import assert_modal_states_agree, one_torch_thread  # noqa: F401

FS = 48000.0
EQ = [biquad_coeffs(FilterType.PEQ, 1000.0, FS, gain=4.0),
      biquad_coeffs(FilterType.HSH, 6000.0, FS, gain=-3.0)]


def _hrtf(rng, ci, n):
    return rng.standard_normal((ci, 2, n)) * np.exp(-np.arange(n) / 60.0)


def _golden(x, hrtf, eq):
    """EQ each input (float64 DF2T), then sum the per-pair convolutions."""
    T = x.shape[-1]
    out = np.zeros((2, T))
    for i in range(x.shape[0]):
        xe = x[i].astype(np.float64)
        for c in eq:
            xe, _ = golden.biquad_process(xe, c)
        for o in range(2):
            out[o] += golden.direct_convolve(xe, hrtf[i, o])[:T]
    return out


def _assert_binaural_states_agree(jr, tr):
    js, ts = jr.state, tr.state
    for a, b in zip(js.eq, ts.eq):
        assert_modal_states_agree(a, b)
    assert int(js.conv.step) == ts.conv.step
    for name in ("queue", "prev"):
        got = getattr(ts.conv, name)
        assert got.is_contiguous(), name
        assert snr_db(np.asarray(getattr(js.conv, name)), got.numpy()) >= 110.0


@pytest.mark.parametrize("B", [64, 256])
def test_binaural_with_eq_and_exchange_matches_jax(rng, B):
    """B = 64 runs the EQ through the general scan, B = 256 through the
    Toeplitz products.  An HRTF exchange at block 6 fades click-free; the
    stream is held against the golden crossfade model, and the meters of
    both packages read alike after ~1.9 s."""
    ci, N = 3, 300
    nb = (int(1.9 * FS) // B) if B == 256 else 24
    h1, h2 = _hrtf(rng, ci, N), _hrtf(rng, ci, N)
    x = (rng.standard_normal((ci, nb * B)) * 0.3).astype(np.float32)
    jr = JaxBinauralRenderer(h1, block=B, eq_stages=EQ, fs=FS)
    tr = BinauralRenderer(h1, block=B, eq_stages=EQ, fs=FS, device="cpu")
    ys = []
    for i in range(nb):
        if i == 6:
            jr.set_hrtf(h2)
            tr.set_hrtf(h2)
        piece = x[:, i * B:(i + 1) * B]
        yj = np.asarray(jr.process_block(jnp.asarray(piece)))
        yt = tr.process_block(torch.from_numpy(piece)).numpy()
        assert snr_db(yj, yt) >= 100.0
        ys.append(yt)
    _assert_binaural_states_agree(jr, tr)
    y = np.concatenate(ys, -1)
    if B == 64:
        ya, yb = _golden(x, h1, EQ), _golden(x, h2, EQ)
        r = np.clip((np.arange(nb * B) - 6 * B + 1) / B, 0.0, 1.0)
        assert snr_db((1 - r) * ya + r * yb, y) >= 90.0
        assert float(np.abs(np.diff(y, axis=-1)).max()) < 20 * float(
            np.median(np.abs(y)))
    else:
        Lj, Lt = jr.loudness(), tr.loudness()
        for k in Lj:
            assert abs(Lj[k] - Lt[k]) <= 0.01, k
        np.testing.assert_array_equal(tr.meter.state.hist_count.numpy(),
                                      np.asarray(jr.meter.state.hist_count))


def test_binaural_state_stays_contiguous(rng):
    ci, B = 2, 64
    tr = BinauralRenderer(_hrtf(rng, ci, 200), block=B, eq_stages=EQ[:1],
                          device="cpu")
    x = rng.standard_normal((ci, B)).astype(np.float32)
    for i in range(4):
        if i == 2:
            tr.set_hrtf(_hrtf(rng, ci, 200))
        tr.process_block(x)
        leaves = [*tr.state.eq[0], tr.state.conv.queue, tr.state.conv.prev,
                  tr.H, tr._meter_buf]
        assert all(t.is_contiguous() for t in leaves)
    with pytest.raises(ValueError, match="expected"):
        tr.process_block(np.zeros((ci, B + 1), np.float32))


def test_binaural_step_without_eq_is_the_matrix_step(rng):
    ci, B = 3, 64
    h = _hrtf(rng, ci, 150)
    tr = BinauralRenderer(h, block=B, device="cpu")
    st = tbinaural.binaural_init((), ci, B, tr.nparts, device="cpu")
    x = torch.from_numpy(rng.standard_normal((ci, B)).astype(np.float32))
    st, y = tbinaural.binaural_step(st, (), tr.H, x)
    assert st.eq == () and st.conv.step == 1
    assert torch.equal(y, tr.process_block(x))


def test_binaural_stream_crosses_from_jax(rng):
    ci, B = 3, 64
    h = _hrtf(rng, ci, 200)
    x = rng.standard_normal((ci, 10 * B)).astype(np.float32)
    jr = JaxBinauralRenderer(h, block=B, eq_stages=EQ, fs=FS)
    tr = BinauralRenderer(h, block=B, eq_stages=EQ, fs=FS, device="cpu")
    for i in range(5):
        jr.process_block(jnp.asarray(x[:, i * B:(i + 1) * B]))
    tr.H, tr.state = binaural_state_from_jax(
        np.asarray(jr.H), jax.tree.map(np.asarray, jr.state), block=B,
        device="cpu")
    _assert_binaural_states_agree(jr, tr)
    for i in range(5, 10):
        piece = x[:, i * B:(i + 1) * B]
        yj = np.asarray(jr.process_block(jnp.asarray(piece)))
        yt = tr.process_block(torch.from_numpy(piece)).numpy()
        assert snr_db(yj, yt) >= 100.0


@pytest.mark.parametrize("in_fmt,out_fmt", [
    ("FLOAT", "FLOAT"), ("INT32", "FLOAT"), ("FLOAT", "INT32"),
    ("INT32", "INT32")])
def test_mixdown_matches_jax(rng, in_fmt, out_fmt):
    """Blocks of 4800 samples, 16 inputs to 2 outputs: outputs compared as
    float at >= 110 dB, integrated loudness within 0.01 LU."""
    C, B, nb = 16, 4800, 6
    gains = (rng.standard_normal((2, C)) * 0.2).astype(np.float32)
    xf = (rng.standard_normal((C, B * nb)) * 0.1).astype(np.float32)
    x = np.array(jdevice.float_to_int32(jnp.asarray(xf))) \
        if in_fmt == "INT32" else xf
    jp = JaxMixdownPipeline(gains, fs=FS, in_format=JaxFormat[in_fmt],
                            out_format=JaxFormat[out_fmt])
    tp = MixdownPipeline(gains, fs=FS, in_format=SampleFormat[in_fmt],
                         out_format=SampleFormat[out_fmt], device="cpu")
    ys = []
    for i in range(nb):
        piece = x[:, i * B:(i + 1) * B]
        yj = np.asarray(jp.process_block(jnp.asarray(piece)))
        yt = tp.process_block(torch.from_numpy(piece)).numpy()
        assert yt.dtype == yj.dtype
        if out_fmt == "INT32":
            yj, yt = yj * 2.0 ** -31, yt * 2.0 ** -31
        assert snr_db(yj, yt) >= 110.0
        ys.append(yt)
    assert abs(jp.integrated_loudness() - tp.integrated_loudness()) <= 0.01
    ref = gains.astype(np.float64) @ xf.astype(np.float64)
    assert snr_db(ref, np.concatenate(ys, -1)) >= 90.0


def test_int32_conversions_bit_exact(rng):
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 0.5,
                        np.array([1.0, -1.0, 1.5, -1.5, 0.0, 2.0 ** -31,
                                  0.99999994], np.float32)])
    i_t = float_to_int32(torch.from_numpy(x)).numpy()
    i_j = np.asarray(jdevice.float_to_int32(jnp.asarray(x)))
    assert i_t.dtype == np.int32
    np.testing.assert_array_equal(i_t, i_j)
    ints = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4096, np.int64),
                           [-2 ** 31, 2 ** 31 - 1, 0, 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        int32_to_float(torch.from_numpy(ints)).numpy(),
        np.asarray(jdevice.int32_to_float(jnp.asarray(ints))))
    assert [is_sample_integer(f) for f in SampleFormat] == [
        False, True, True, True, False, False]
    assert [int(f) for f in SampleFormat] == [int(f) for f in JaxFormat]
