"""The models and the two-level engine in bfloat16 and float16 against
the JAX package built with the same dtype: ``EQDelayPipeline`` (both
delay paths and the modal fallback), ``MixdownPipeline``,
``BinauralRenderer`` with an HRTF exchange, and the two-level engine's
narrow tail queue through ``process_block`` with both exchange forms.
The crossings are in ``test_torch_narrow_state.py``.  The checks are
those of
``test_torch_narrow.py``: leaves and dtypes, the reference run operation
by operation, and the SNR against float64 within 1 dB of the compiled
reference's (float16 as recorded there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxNonUniform
from bbcat_dsp_tpu.models import binaural as jbinaural
from bbcat_dsp_tpu.models import pipeline as jpipeline
from bbcat_dsp_torch import NonUniformConvolver
from bbcat_dsp_torch.models import binaural as tbinaural
from bbcat_dsp_torch.models import pipeline as tpipeline
from conftest import snr_db
from test_torch_iir import one_torch_thread  # noqa: F401
from test_torch_narrow import (
    FS,
    IDS,
    NARROW,
    _assert_gap,
    _bits_equal,
    _f64,
    _lfilter_cascade,
    _leaves_agree,
    _same_dtype,
    _spec,
    _within_one_step,
    eq_stages,
)


def _dtypes(state) -> list:
    """The dtypes of a state's array leaves (not its counters), JAX's or
    the port's."""
    return [str(a.dtype).replace("torch.", "") for a in jax.tree.leaves(state)
            if getattr(a, "ndim", 0)]


# ---- EQDelayPipeline ------------------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("coeffs,parallel", [
    (eq_stages(3), True),
    (np.concatenate([eq_stages(2), eq_stages(1)]), False),   # a stage twice
], ids=["parallel", "modal"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["delay-a-channel", "delay-a-sample"])
def test_a_narrow_eq_delay_pipeline_matches_jax(rng, tdt, jdt, coeffs,
                                               parallel, per_sample):
    """The cascade's parameters and initial state and the ring narrow, the
    cascade's state float32 after a block, the output narrow; against
    JAX run operation by operation, bit for bit; against the float32
    pipeline (which reads > 130 dB against float64, far above the narrow
    types), within 1 dB of JAX's."""
    C, B, nblk, max_delay = 3, 256, 4, 60.0
    jp = jpipeline.EQDelayPipeline(coeffs, C, B, max_delay, FS, jdt)
    jo = jpipeline.EQDelayPipeline(coeffs, C, B, max_delay, FS, jdt)
    tp = tpipeline.EQDelayPipeline(coeffs, C, B, max_delay, FS, tdt,
                                   device="cpu")
    t32 = tpipeline.EQDelayPipeline(coeffs, C, B, max_delay, FS,
                                    device="cpu")
    assert (tp.psos is not None) == parallel == (jp.psos is not None)
    _leaves_agree(jp.psos if parallel else jp.params,
                  tp.psos if parallel else tp.params)
    _leaves_agree(jp.state, tp.state)
    yj, yt, y32 = [], [], []
    for i in range(nblk):
        x = rng.standard_normal((C, B)).astype(np.float32)
        k = rng.integers(10 * 128, int(max_delay) * 128,
                         (C, B) if per_sample else (C,))
        d = (np.sort(k, -1) / 128.0 + 1 / 256).astype(np.float32)
        yj.append(jp.process_block(jnp.asarray(x), d))
        with jax.disable_jit():
            yo = jo.process_block(jnp.asarray(x), d)
        yt.append(tp.process_block(x, d))
        assert yt[-1].dtype == tdt and _same_dtype(yj[-1], yt[-1])
        _bits_equal(yo, yt[-1])
        _leaves_agree(jo.state, tp.state)
        y32.append(_f64(t32.process_block(x, d)))
    assert _dtypes(jp.state) == _dtypes(tp.state)
    # the delay a sample reads by the gather, the compiled reference's
    # fused narrow sum
    _assert_gap("fractional_read" if per_sample else "EQDelayPipeline", jdt,
                np.concatenate(y32, -1),
                np.concatenate([_f64(a) for a in yj], -1),
                np.concatenate([_f64(a) for a in yt], -1))


# ---- MixdownPipeline ----------------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_mixdown_matches_jax(rng, tdt, jdt):
    """The gains narrow and mixed widened: the output is float32, and the
    float32 pipeline with the rounded gains gives it exactly."""
    g = rng.standard_normal((2, 6)) * 0.3
    jm = jpipeline.MixdownPipeline(g, FS, dtype=jdt)
    tm = tpipeline.MixdownPipeline(g, FS, dtype=tdt, device="cpu")
    twin = tpipeline.MixdownPipeline(tm.gains.float().numpy(), FS,
                                     device="cpu")
    _within_one_step(jm.gains, tm.gains)
    for _ in range(5):
        x = (rng.standard_normal((6, 4800)) * 0.2).astype(np.float32)
        yj = jm.process_block(jnp.asarray(x))
        yt = tm.process_block(torch.from_numpy(x))
        assert yt.dtype == torch.float32 and _same_dtype(yj, yt)
        assert torch.equal(yt, twin.process_block(torch.from_numpy(x)))
        assert snr_db(_f64(yj), _f64(yt)) >= 130.0
    assert abs(jm.integrated_loudness() - tm.integrated_loudness()) <= 0.01


# ---- BinauralRenderer --------------------------------------------------------

def _hrtf(rng, ci, n):
    return rng.standard_normal((ci, 2, n)) * np.exp(-np.arange(n) / 40.0)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_binaural_renderer_matches_jax(rng, tdt, jdt):
    """The EQ's parameters and initial state and the matrix queue narrow;
    the EQ state and ``prev`` float32 after a block, the queue narrow, the
    output float32.  An HRTF exchange at block 4.  Against the float64
    chain (``lfilter``, ``fftconvolve``, the crossfade), within 1 dB of
    JAX's."""
    ci, B, N, nb = 3, 256, 300, 10
    eq = eq_stages(2)
    h1, h2 = _hrtf(rng, ci, N), _hrtf(rng, ci, N)
    x = (rng.standard_normal((ci, nb * B)) * 0.3).astype(np.float32)
    jr = jbinaural.BinauralRenderer(h1, B, eq_stages=eq, fs=FS, dtype=jdt)
    jo = jbinaural.BinauralRenderer(h1, B, eq_stages=eq, fs=FS, dtype=jdt)
    tr = tbinaural.BinauralRenderer(h1, B, eq_stages=eq, fs=FS, dtype=tdt,
                                    device="cpu")
    _leaves_agree(jr.eq_params, tr.eq_params)
    _leaves_agree(jr.state.eq, tr.state.eq)
    assert _same_dtype(jr.state.conv.queue, tr.state.conv.queue)
    yj, yt = [], []
    for i in range(nb):
        if i == 4:
            for r in (jr, jo, tr):
                r.set_hrtf(h2)
        piece = x[:, i * B:(i + 1) * B]
        yj.append(jr.process_block(jnp.asarray(piece)))
        with jax.disable_jit():
            yo = jo.process_block(jnp.asarray(piece))
        yt.append(tr.process_block(torch.from_numpy(piece)))
        assert yt[-1].dtype == torch.float32 and _same_dtype(yj[-1], yt[-1])
        # the narrow queues one step apart in a few entries (below), as the
        # convolvers' narrow streams (test_torch_dtype.py): >= 80 dB
        assert snr_db(_f64(yo), _f64(yt[-1])) >= 80.0
    assert _dtypes(jr.state) == _dtypes(tr.state)
    # the queue rounds float32 windows that the two packages' transforms
    # give to ~1e-7: one step apart where a window sits at a boundary
    _within_one_step(jo.state.conv.queue, tr.state.conv.queue)
    e = _lfilter_cascade(x, eq)
    ya = np.stack([sum(fftconvolve(e[c], h1[c, o])[:nb * B] for c in
                       range(ci)) for o in range(2)])
    yb = np.stack([sum(fftconvolve(e[c], h2[c, o])[:nb * B] for c in
                       range(ci)) for o in range(2)])
    r = np.clip((np.arange(nb * B) - 4 * B + 1) / B, 0.0, 1.0)
    _assert_gap("BinauralRenderer", jdt, (1 - r) * ya + r * yb,
                np.concatenate([_f64(a) for a in yj], -1),
                np.concatenate([_f64(a) for a in yt], -1))


# ---- the two-level engine ------------------------------------------------------

N2 = 300          # block 16, ratio 4: head 128 taps, tail 3 partitions of 64


def _irs(rng, C, n):
    return rng.standard_normal((C, n)) * np.exp(-np.arange(n) / 80.0)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_the_narrow_two_level_engine_streams_process_block_as_jax(
        rng, tdt, jdt):
    """Only the tail queue is narrow (JAX's other leaves are narrow zeros
    before the first block and float32 after it); an exchange of every IR
    at super-block 5 and of one channel's at super-block 9; against JAX's
    narrow ``process_block`` and against float64 within 1 dB of JAX's."""
    C, nsup = 3, 14
    irs, swap, one = _irs(rng, C, N2), _irs(rng, C, N2), _irs(rng, 1, N2)[0]
    x = rng.standard_normal((C, nsup * 64)).astype(np.float32)
    jc = JaxNonUniform(irs, 16, 4, dtype=jdt, spectral=(_spec(32), _spec(128)))
    tc = NonUniformConvolver(irs, 16, 4, dtype=tdt, device="cpu")
    assert tc.state.tail.queue.dtype == tdt
    assert tc.state.xcarry.dtype == tc.state.pending.dtype == torch.float32
    yj, yt = [], []
    for j in range(nsup):
        if j == 5:
            jc.set_filter(swap)
            tc.set_filter(swap)
        if j == 9:
            jc.set_filter(one, channel=1)
            tc.set_filter(one, channel=1)
        piece = x[:, j * 64:(j + 1) * 64]
        yj.append(_f64(jc.process_block(jnp.asarray(piece))))
        yt.append(_f64(tc.process_block(piece)))
        assert snr_db(yj[-1], yt[-1]) >= 80.0
        _within_one_step(jc.state.tail.queue, tc.state.tail.queue)
        assert _dtypes(jc.state) == _dtypes(tc.state)
    # float64 up to the first exchange
    y64 = np.stack([fftconvolve(x[c].astype(np.float64), irs[c])[:5 * 64]
                    for c in range(C)])
    _assert_gap("NonUniformConvolver", jdt, y64,
                np.concatenate(yj, -1)[:, :5 * 64],
                np.concatenate(yt, -1)[:, :5 * 64])
