"""The port's all-pass, comb and Schroeder reverb against the JAX package
and the float64 golden all-pass.

The same numpy inputs go through both packages on the CPU.  Against the
float64 per-sample loop (``golden/allpass.py``, and a comb written out
here): >= 90 dB, the bar of ``tests/test_filters.py``.  Against the JAX
package, which does the same float32 arithmetic (a first-order scan over
each phase of the delay; the scans' trees differ): >= 110 dB on output
and on the rings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.filters import allpass as jallpass
from bbcat_dsp_tpu.models import reverb as jreverb
from bbcat_dsp_torch.filters import (
    AllPassFilter,
    AllPassFilterChain,
    allpass_apply,
    comb_apply,
)
from bbcat_dsp_torch.models import SchroederReverb
from conftest import snr_db


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def comb64(x, g, d, ring=None):
    """``y[n] = x[n] + g y[n - d]`` in float64, sample by sample; the ring
    is the last ``d`` outputs, oldest first."""
    x = np.asarray(x, np.float64)
    hist = np.zeros(x.shape[:-1] + (d,)) if ring is None else np.asarray(
        ring, np.float64)
    y = np.concatenate([hist, np.zeros_like(x)], -1)
    for n in range(x.shape[-1]):
        y[..., d + n] = x[..., n] + g * y[..., n]
    return y[..., d:], y[..., -d:]


# delays below, equal to and above the block length; a block of one sample
SHAPES = [(7, 512), (16, 500), (5, 3), (64, 64), (100, 37), (1, 50), (9, 1),
          (3, 1000)]


@pytest.mark.parametrize("delay,T", SHAPES)
def test_allpass_vs_golden_and_jax(rng, delay, T):
    x = rng.standard_normal((2, T)).astype(np.float32)
    ring = rng.standard_normal((2, delay)).astype(np.float32)
    for w0 in (None, ring):
        y_ref, w_ref = golden.allpass_process(x, 0.5, delay, w0)
        jy, jw = jallpass.allpass_apply(
            jnp.asarray(x), 0.5, delay, None if w0 is None else jnp.asarray(w0))
        ty, tw = allpass_apply(
            torch.from_numpy(x), 0.5, delay,
            None if w0 is None else torch.from_numpy(w0))
        assert ty.shape == (2, T) and tw.shape == (2, delay)
        assert snr_db(y_ref, ty.numpy()) > 90.0
        np.testing.assert_allclose(tw.numpy(), w_ref, atol=1e-5)
        assert snr_db(np.asarray(jy), ty.numpy()) >= 110.0
        assert snr_db(np.asarray(jw), tw.numpy()) >= 110.0


@pytest.mark.parametrize("delay,T", SHAPES)
def test_comb_vs_float64_and_jax(rng, delay, T):
    x = rng.standard_normal((2, T)).astype(np.float32)
    ring = rng.standard_normal((2, delay)).astype(np.float32)
    for r0 in (None, ring):
        y_ref, r_ref = comb64(x, 0.8, delay, r0)
        jy, jr = jallpass.comb_apply(
            jnp.asarray(x), 0.8, delay, None if r0 is None else jnp.asarray(r0))
        ty, tr = comb_apply(
            torch.from_numpy(x), 0.8, delay,
            None if r0 is None else torch.from_numpy(r0))
        assert ty.shape == (2, T) and tr.shape == (2, delay)
        assert snr_db(y_ref, ty.numpy()) > 90.0
        np.testing.assert_allclose(tr.numpy(), r_ref, atol=1e-4)
        assert snr_db(np.asarray(jy), ty.numpy()) >= 110.0
        assert snr_db(np.asarray(jr), tr.numpy()) >= 110.0


@pytest.mark.parametrize("apply_fn,block", [
    (allpass_apply, 64), (allpass_apply, 5), (comb_apply, 64),
    (comb_apply, 5)])
def test_streaming_equals_one_shot(rng, apply_fn, block):
    """Blocks longer and shorter than the delay of 7 against one call."""
    x = torch.from_numpy(rng.standard_normal((2, 320)).astype(np.float32))
    y_full, ring_full = apply_fn(x, 0.3, 7)
    ring, outs = None, []
    for i in range(320 // block):
        y, ring = apply_fn(x[:, i * block:(i + 1) * block], 0.3, 7, ring)
        outs.append(y)
    assert snr_db(y_full.numpy(), torch.cat(outs, -1).numpy()) > 120.0
    np.testing.assert_allclose(ring.numpy(), ring_full.numpy(), atol=1e-5)


def test_float64_signal_stays_float64(rng):
    x = rng.standard_normal((2, 300))
    y, w = allpass_apply(torch.from_numpy(x), 0.6, 11)
    assert y.dtype == w.dtype == torch.float64
    assert snr_db(golden.allpass_process(x, 0.6, 11)[0], y.numpy()) > 250.0


def test_allpass_classes(rng):
    """``AllPassFilter`` and a chain of three over four blocks against
    the golden all-passes one after the other; ``reset``."""
    specs = [(7, 0.5), (13, -0.4), (31, 0.7)]
    chain = AllPassFilterChain([AllPassFilter(2, d, c, device="cpu")
                                for d, c in specs])
    x = rng.standard_normal((2, 256)).astype(np.float32)
    ref = x.astype(np.float64)
    for d, c in specs:
        ref, _ = golden.allpass_process(ref, c, d)
    y = torch.cat([chain.process(x[:, i * 64:(i + 1) * 64])
                   for i in range(4)], -1)
    assert snr_db(ref, y.numpy()) > 90.0
    chain.reset()
    assert all(float(f.w.abs().max()) == 0.0 for f in chain.filters)
    assert snr_db(ref[:, :64], chain.process(x[:, :64]).numpy()) > 90.0


# ---- the reverb ----------------------------------------------------------------

def reverb64(rev, x):
    """The reverb's topology in float64, sample by sample: four combs side
    by side, averaged, then three all-passes, each channel with its own
    delays."""
    out = np.zeros_like(x, dtype=np.float64)
    for c in range(x.shape[0]):
        wet = sum(comb64(x[c], gs[c], ds[c])[0]
                  for ds, gs in zip(rev.comb_delays, rev.comb_gains)) / 4.0
        for ds in rev.ap_delays:
            wet = golden.allpass_process(wet, 0.7, ds[c])[0][0]
        out[c] = (1.0 - rev.mix) * x[c] + rev.mix * wet
    return out


@pytest.mark.parametrize("fs,block,nblk", [(8000.0, 128, 12), (48000.0, 512, 8)])
def test_reverb_matches_jax_over_several_blocks(rng, fs, block, nblk):
    """Two channels: at 8 kHz the delays (455-540 and 72-185 samples) span
    several blocks of 128 and the all-passes scan; at 48 kHz every comb is
    longer than the block of 512.  Output and every ring >= 110 dB against
    the JAX package, the output >= 90 dB against float64."""
    C = 2
    jr = jreverb.SchroederReverb(C, fs=fs, rt60=0.8)
    tr = SchroederReverb(C, fs=fs, rt60=0.8, device="cpu")
    assert tr.comb_delays == jr.comb_delays and tr.ap_delays == jr.ap_delays
    assert tr.comb_gains == jr.comb_gains
    x = rng.standard_normal((C, nblk * block)).astype(np.float32)
    ys = []
    for k in range(nblk):
        sl = slice(k * block, (k + 1) * block)
        jy = np.asarray(jr.process_block(jnp.asarray(x[:, sl])))
        ty = tr.process_block(torch.from_numpy(x[:, sl])).numpy()
        assert snr_db(jy, ty) >= 110.0, k
        ys.append(ty)
    for jrs, trs in ((jr._comb_rings, tr._comb_rings),
                     (jr._ap_rings, tr._ap_rings)):
        for jrow, trow in zip(jrs, trs):
            for a, b in zip(jrow, trow):
                assert b.shape == a.shape
                assert snr_db(np.asarray(a), b.numpy()) >= 110.0
    assert snr_db(reverb64(tr, x), np.concatenate(ys, -1)) > 90.0
    tr.reset()
    assert snr_db(ys[0], tr.process_block(x[:, :block]).numpy()) > 140.0
