"""The port's parallel biquad cascade and ``EQDelayPipeline`` against the
JAX package.

The same numpy inputs go through both packages on the CPU.  The cascade is
streamed over several calls at block lengths that take each of its
branches (T = 4096 and 256: the Toeplitz products; T = 100: the doubling
scan) and held on output and on state at >= 110 dB; the K pole states are
compared as complex numbers.  The pipeline runs 3 channels through 3
stages over several blocks on both delay paths (one delay a channel, one a
sample) and on the fallback to the serial modal engine, its state crossing
from JAX into the port mid-stream.

The JAX pipeline subtracts a float32 delay from its monotonic int32 write
position before it reduces modulo the ring's length, so its delays lose
resolution as a stream grows (below 1/128 sample from 2^17 samples on).
The port reduces in integers first.  The two are therefore compared where
the JAX package is exact: write positions below 2^16 and delays on the
grid ``k / 128 + 1 / 256``, which float32 holds exactly there; and one
test records the reference's loss as it is, next to the port's
invariance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.buffers import ring as jring
from bbcat_dsp_tpu.filters import iir as jiir
from bbcat_dsp_tpu.models import pipeline as jpipeline
from bbcat_dsp_torch import EQDelayPipeline
from bbcat_dsp_torch.buffers import ring_advance
from bbcat_dsp_torch.filters import (
    FilterType,
    ParallelCascadeState,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from bbcat_dsp_torch.models import EQDelayState
from bbcat_dsp_torch.utils.interop import eq_delay_state_from_jax, to_numpy
from conftest import snr_db

FS = 48000.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eq_stages(n: int) -> np.ndarray:
    """``n`` PEQ stages at 100 (i + 1) Hz, +/- 3 dB alternating: the
    BASELINE cascade, cut to ``n`` stages."""
    return np.stack([golden.biquad_coeffs(FilterType.PEQ, 100.0 * (i + 1), FS,
                                          gain=3.0 * (-1) ** i)
                     for i in range(n)])


def complex_snr_db(ref_re, ref_im, re, im) -> float:
    ref = np.asarray(ref_re, np.float64) + 1j * np.asarray(ref_im, np.float64)
    got = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    noise = np.sum(np.abs(ref - got) ** 2)
    return np.inf if noise == 0 else 10 * np.log10(
        np.sum(np.abs(ref) ** 2) / noise)


def grid_delays(rng, shape, lo: float, hi: float) -> np.ndarray:
    """Delays in ``[lo, hi)`` on the grid ``k / 128 + 1 / 256``."""
    k = rng.integers(int(lo * 128), int(hi * 128), shape)
    return (k / 128.0 + 1.0 / 256.0).astype(np.float32)


# ---- the parallel cascade -------------------------------------------------------

def test_parallel_cascade_params_match_jax():
    c = eq_stages(3)
    want = jiir.parallel_cascade_params(c)
    got = parallel_cascade_params(c, device="cpu")
    assert got._fields == want._fields
    for name in got._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("T,batch", [
    (4096, (3,)),     # Toeplitz products, 32 chunks
    (256, (2, 2)),    # the shortest Toeplitz block, two batch axes
    (100, (3,)),      # the doubling scan
    (257, (2,)),      # just past the gate: the scan again
])
def test_parallel_cascade_apply_matches_jax(rng, T, batch):
    c = eq_stages(3)
    jp = jiir.parallel_cascade_params(c)
    tp = parallel_cascade_params(c, device="cpu")
    js = ts = None
    for _ in range(3):
        x = rng.standard_normal(batch + (T,)).astype(np.float32)
        jy, js = jiir.parallel_cascade_apply(jnp.asarray(x), jp, js)
        ty, ts = parallel_cascade_apply(torch.from_numpy(x), tp, ts)
        assert ty.shape == x.shape
        assert snr_db(np.asarray(jy), ty.numpy()) >= 110.0
        assert ts.sr.shape == (6,) + batch
        assert ts.sr.is_contiguous() and ts.si.is_contiguous()
        assert complex_snr_db(js.sr, js.si, ts.sr.numpy(),
                              ts.si.numpy()) >= 110.0


def test_parallel_cascade_apply_against_float64(rng):
    from scipy.signal import lfilter

    c = eq_stages(3)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    ref = x.astype(np.float64)
    for s in c:
        ref = lfilter(s[:3], np.r_[1.0, s[3:]], ref, axis=-1)
    y, _ = parallel_cascade_apply(torch.from_numpy(x),
                                  parallel_cascade_params(c, device="cpu"))
    assert snr_db(ref, y.numpy()) >= 110.0


@pytest.mark.parametrize("coeffs,match", [
    ([[1.0, 0.0, 0.0, -2.1, 1.1]], "unstable"),            # a pole outside
    (np.concatenate([eq_stages(1)] * 2), "clustered"),     # two equal stages
    ([[1.0, 0.5, 0.0, -0.5, 0.0]], "zero pole"),           # a2 == 0
])
def test_parallel_cascade_params_refuse_ill_conditioned(coeffs, match):
    with pytest.raises(ValueError):
        jiir.parallel_cascade_params(np.asarray(coeffs))
    with pytest.raises(ValueError, match=match):
        parallel_cascade_params(np.asarray(coeffs), device="cpu")


# ---- the pipeline ---------------------------------------------------------------

def assert_states_agree(js, ts: EQDelayState):
    """``js`` the JAX ``EQDelayState``, ``ts`` the port's, at >= 110 dB.
    The serial engine's pole states are held to 110 dB below the signal
    (unit variance here: an rms error of 3e-6), not below themselves: a
    PEQ's modal states are some 30 times smaller than the signal that
    passes (their taps are ``b1 - a1 b0`` and ``b2 - a2 b0``), one sample
    a channel, and both float32 engines round at the signal's scale."""
    assert int(js.ring.writepos) == ts.ring.writepos
    assert snr_db(np.asarray(js.ring.data), ts.ring.data.numpy()) >= 110.0
    if isinstance(ts.eq, ParallelCascadeState):
        assert complex_snr_db(js.eq.sr, js.eq.si, ts.eq.sr.numpy(),
                              ts.eq.si.numpy()) >= 110.0
        return
    assert len(js.eq) == len(ts.eq)
    for a, b in zip(js.eq, ts.eq):
        assert snr_db(np.asarray(a.x1), b.x1.numpy()) >= 110.0
        assert snr_db(np.asarray(a.x2), b.x2.numpy()) >= 110.0
        for name in ("tr", "ti", "wr", "wi"):
            err = np.asarray(getattr(a, name)) - getattr(b, name).numpy()
            assert np.sqrt(np.mean(err ** 2)) <= 3e-6, name


def jax_leaves(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("coeffs,parallel", [
    (eq_stages(3), True),
    (np.concatenate([eq_stages(2), eq_stages(1)]), False),   # a stage twice
])
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("B", [256, 100])
def test_eq_delay_pipeline_matches_jax(rng, coeffs, parallel, per_sample, B):
    C, nblk, max_delay = 3, 6, 100.0
    jp = jpipeline.EQDelayPipeline(coeffs, C, B, max_delay, FS)
    tp = EQDelayPipeline(coeffs, C, B, max_delay, FS, device="cpu")
    assert (tp.psos is not None) == parallel == (jp.psos is not None)
    assert tp.length == jp.length
    assert_states_agree(jp.state, tp.state)
    for i in range(nblk):
        x = rng.standard_normal((C, B)).astype(np.float32)
        delays = grid_delays(rng, (C, B) if per_sample else (C,), 0.0,
                             max_delay)
        if per_sample:       # a slow glide, as a moving source's delay
            delays = np.sort(delays, axis=-1)
        want = np.asarray(jp.process_block(jnp.asarray(x), delays))
        got = tp.process_block(x, delays).numpy()
        assert got.shape == (C, B)
        assert snr_db(want, got) >= 110.0
        assert_states_agree(jp.state, tp.state)
        if i == 2:
            # the stream crosses from JAX into the port here
            tp.state = eq_delay_state_from_jax(jax_leaves(jp.state),
                                               device="cpu")
            assert_states_agree(jp.state, tp.state)
    assert tp.state.ring.writepos == nblk * B
    back = to_numpy(tp.state)
    assert isinstance(back, EQDelayState)
    assert back.ring.data.shape == (C, tp.length)


def test_eq_delay_pipeline_continues_a_jax_stream_without_a_click(rng):
    """A port pipeline that never saw the stream's first half continues it
    from the JAX state as the JAX pipeline itself does."""
    C, B = 3, 256
    coeffs = eq_stages(3)
    delays = grid_delays(rng, (C,), 20.0, 90.0)
    t = np.arange(8 * B) / FS
    x = np.sin(2 * np.pi * 220.0 * t * np.arange(1, C + 1)[:, None]).astype(
        np.float32)
    jp = jpipeline.EQDelayPipeline(coeffs, C, B, 100.0, FS)
    first = [np.asarray(jp.process_block(jnp.asarray(x[:, i * B:(i + 1) * B]),
                                         delays)) for i in range(4)]
    tp = EQDelayPipeline(coeffs, C, B, 100.0, FS, device="cpu")
    tp.state = eq_delay_state_from_jax(jax_leaves(jp.state), device="cpu")
    for i in range(4, 8):
        blk = x[:, i * B:(i + 1) * B]
        want = np.asarray(jp.process_block(jnp.asarray(blk), delays))
        got = tp.process_block(blk, delays).numpy()
        assert snr_db(want, got) >= 110.0
        # no discontinuity where the port took over: the step across the
        # seam is no larger than the steps of this sine inside the block
        if i == 4:
            seam = np.abs(got[:, 0] - first[-1][:, -1])
            assert np.all(seam <= 1.5 * np.abs(np.diff(got, axis=-1)).max(-1))


def test_long_streams_keep_their_delay_in_the_port_and_lose_it_in_jax(rng):
    """Moving the write position by whole ring lengths changes no sample's
    place in the ring.  The port's output does not change by a bit.  The
    JAX pipeline's does: it forms ``writepos - delay`` in float32 before
    the modulo, and float32 resolves 1/128 sample only below 2^17.  This
    records the reference as it is; the port does not copy it."""
    eq = np.array([[1.0, 0.0, 0.0, 0.0, 0.0]])     # identity: the delay alone
    C, B, max_delay = 2, 64, 50.0                  # ring length 128
    x = rng.standard_normal((4, C, B)).astype(np.float32)
    delays = np.array([10.3, 25.77], np.float32)

    def run_jax(advance):
        p = jpipeline.EQDelayPipeline(eq, C, B, max_delay)
        p.state = jpipeline.EQDelayState(
            p.state.eq, jring.ring_advance(p.state.ring, advance))
        return np.concatenate(
            [np.asarray(p.process_block(jnp.asarray(b), delays)) for b in x],
            -1)

    def run_port(advance):
        p = EQDelayPipeline(eq, C, B, max_delay, device="cpu")
        assert p.length == 128
        p.state = p.state._replace(ring=ring_advance(p.state.ring, advance))
        return np.concatenate(
            [p.process_block(b, delays).numpy() for b in x], -1)

    jax0, port0 = run_jax(0), run_port(0)
    assert snr_db(jax0, port0) >= 110.0
    assert np.array_equal(run_jax(1 << 10), jax0)  # exact while it is short
    for advance, at_most in ((1 << 17, 45.0), (1 << 21, 30.0),
                             (1 << 25, 3.0), (3 * (1 << 40), None)):
        assert np.array_equal(run_port(advance), port0)
        if at_most is not None:
            assert snr_db(jax0, run_jax(advance)) <= at_most
