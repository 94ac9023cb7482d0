"""The port's BS.1770 loudness and true peak against the JAX package, and
the EBU compliance cases on the port alone.

The same numpy inputs go through both packages on the CPU.  K-weighted
signals and gating-block powers are held at >= 110 dB, loudness readouts
within 0.01 LU, histogram counts exactly, true peak at >= 100 dB.  The
meter's filter states are held as complex pole-state pairs (see
``test_torch_iir.py``) at >= 110 dB, but for the RLB stage's.  RLB's poles
sit at |p| = 0.995, so a float32 rounding grows by about 1 / (1 - |p|) =
200 (46 dB) in its first pole state ``t`` and again in its second, ``w``;
the JAX package's own ``w`` lies about 100 dB from a float64 recursion,
so the two packages can agree no closer than that.  The RLB states are
held pooled over every channel and every call of a stream (a single call's
few channels are too few values for a stable SNR): ``t`` at >= 110 dB,
``w`` at >= 90 dB.  The signal that leaves the filter (``y = x + Re w``)
holds >= 110 dB all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu import loudness as jl
from bbcat_dsp_torch import loudness as tl
from bbcat_dsp_torch.utils.interop import meter_state_from_jax
from conftest import snr_db
from test_torch_iir import (  # noqa: F401
    assert_modal_states_agree,
    complex_snr_db,
    one_torch_thread,
)

FS = 48000.0


def _sine(db_fs, seconds, nch=2, f=997.0, fs=FS):
    t = np.arange(round(seconds * fs)) / fs
    x = 10.0 ** (db_fs / 20.0) * np.sin(2 * np.pi * f * t)
    return np.broadcast_to(x, (nch, x.size)).astype(np.float32)


def _seq(*segs):
    return np.concatenate([_sine(db, s) for db, s in segs], axis=-1)


def _noise(rng, C, T, levels=None):
    x = rng.standard_normal((C, T)) * 0.1
    if levels is not None:
        x *= np.asarray(levels)[:, None]
    return x.astype(np.float32)


@pytest.mark.parametrize("fs", [44100.0, 48000.0, 96000.0])
def test_k_weighting_coeffs_match_golden(fs):
    np.testing.assert_allclose(tl.k_weighting_coeffs(fs),
                               golden.k_weighting_coeffs(fs), rtol=0,
                               atol=1e-12)


def test_constants_match_golden():
    from bbcat_dsp_tpu.golden import loudness as gl
    from bbcat_dsp_torch.loudness import itu1770

    np.testing.assert_array_equal(itu1770.CHANNEL_WEIGHTS_5_1,
                                  gl.CHANNEL_WEIGHTS_5_1)
    assert (itu1770.ABSOLUTE_GATE_LKFS, itu1770.RELATIVE_GATE_LU) == (
        gl.ABSOLUTE_GATE_LKFS, gl.RELATIVE_GATE_LU)
    for n in (1, 2, 5, 6, 128):
        np.testing.assert_array_equal(tl.default_channel_weights(n),
                                      jl.default_channel_weights(n))


@pytest.mark.parametrize("T", [4800, 9600])
def test_k_weight_matches_jax(rng, T):
    """T = 4800 takes the general scan, T = 9600 the Toeplitz products;
    two calls continue one stream."""
    x = _noise(rng, 8, 2 * T)
    sj = st = None
    rlb_states = RlbStates()
    for k in range(2):
        piece = x[:, k * T:(k + 1) * T]
        yj, sj = jl.k_weight(jnp.asarray(piece), FS, sj)
        yt, st = tl.k_weight(torch.from_numpy(piece), FS, st)
        assert snr_db(np.asarray(yj), yt.numpy()) >= 110.0
        assert_modal_states_agree(sj[0], st[0])
        assert_modal_states_agree(sj[1], st[1], check_poles=False)
        rlb_states.add(sj[1], st[1])
    rlb_states.check()
    ref = golden.loudness.k_weight(x, FS)[:, T:]
    assert snr_db(ref, yt.numpy()) >= 90.0


class RlbStates:
    """The RLB stage's pole states of both packages, pooled over a stream:
    ``t`` held at >= 110 dB, ``w`` at >= 90 dB (see the module's
    docstring)."""

    def __init__(self):
        self.leaves = []

    def add(self, js, ts):
        self.leaves.append([np.asarray(getattr(js, f)) for f in
                            ("tr", "ti", "wr", "wi")]
                           + [getattr(ts, f).numpy() for f in
                              ("tr", "ti", "wr", "wi")])

    def check(self):
        jtr, jti, jwr, jwi, ttr, tti, twr, twi = (
            np.concatenate(a) for a in zip(*self.leaves))
        assert complex_snr_db(jtr, jti, ttr, tti) >= 110.0
        assert complex_snr_db(jwr, jwi, twr, twi) >= 90.0


def test_block_powers_and_integrated_match_jax(rng):
    x = _noise(rng, 5, int(2.5 * FS), [1.0, 0.5, 0.25, 0.8, 0.3])
    zj, _ = jl.block_powers(jnp.asarray(x), FS)
    zt, _ = tl.block_powers(torch.from_numpy(x), FS)
    assert zt.shape == zj.shape
    assert snr_db(np.asarray(zj), zt.numpy()) >= 110.0
    Lj = float(jl.integrated_loudness(jnp.asarray(x), FS))
    Lt = float(tl.integrated_loudness(torch.from_numpy(x), FS))
    assert abs(Lt - Lj) <= 0.01
    assert abs(Lt - golden.integrated_loudness(x, FS)) <= 0.05


def test_gated_integrated_matches_jax():
    """A burst then silence: the gates drop the silent blocks; all blocks
    below the absolute gate read -inf."""
    x = np.concatenate([_sine(-20.0, 1.0, 1), np.zeros((1, int(4 * FS)),
                                                      np.float32)], -1)
    Lj = float(jl.integrated_loudness(jnp.asarray(x), FS))
    Lt = float(tl.integrated_loudness(torch.from_numpy(x), FS))
    assert abs(Lt - Lj) <= 0.01 and -24.5 < Lt < -22.5
    silent = torch.zeros(2, int(FS))
    assert float(tl.integrated_loudness(silent, FS)) == -np.inf


def _assert_meters_agree(jm, tm, rlb_states):
    js, ts = jm.state, tm.state
    assert_modal_states_agree(js.shelf, ts.shelf)
    assert_modal_states_agree(js.rlb, ts.rlb, check_poles=False)
    rlb_states.add(js.rlb, ts.rlb)
    for name in ("sq_tail", "hist_sum", "momentary_z", "short_ring",
                 "st_sum"):
        want, got = np.asarray(getattr(js, name)), getattr(ts, name)
        assert got.shape == want.shape and got.is_contiguous(), name
        if np.any(want):
            assert snr_db(want, got.numpy()) >= 110.0, name
        else:
            assert not got.any(), name
    for name in ("hist_count", "st_count"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.nblocks == int(js.nblocks)
    for fn in ("momentary", "short_term", "integrated"):
        a, b = getattr(jm, fn)(), getattr(tm, fn)()
        assert a == b or abs(a - b) <= 0.01, fn
    assert abs(jm.loudness_range() - tm.loudness_range()) <= 0.01


def test_streamed_meter_matches_jax(rng):
    """Chunks of 4800 (general scan), 9600 and 48000 samples (Toeplitz)
    through both meters, every state leaf and readout held after each; a
    20 dB level step half-way moves the gates."""
    chunks = [4800, 9600, 48000, 4800, 48000, 9600, 48000, 48000]
    T = sum(chunks)
    x = _noise(rng, 2, T)
    x[:, T // 2:] *= 0.1
    jm, tm = jl.LoudnessMeter(2, FS), tl.LoudnessMeter(2, FS, device="cpu")
    t0, rlb_states = 0, RlbStates()
    for n in chunks:
        jm.process(jnp.asarray(x[:, t0:t0 + n]))
        tm.process(torch.from_numpy(x[:, t0:t0 + n]))
        t0 += n
        _assert_meters_agree(jm, tm, rlb_states)
    rlb_states.check()
    assert abs(tm.integrated() - golden.integrated_loudness(x, FS)) < 0.1


def test_meter_refuses_unaligned_chunks_and_resets(rng):
    tm = tl.LoudnessMeter(2, FS, device="cpu")
    for T in (0, 4799):
        with pytest.raises(ValueError, match="multiple"):
            tm.process(torch.zeros(2, T))
    x = torch.from_numpy(_noise(rng, 2, 48000))
    tm.process(x)
    first = tm.integrated()
    tm.reset()
    assert tm.state.nblocks == 0 and tm.integrated() == -np.inf
    tm.process(x)
    assert tm.integrated() == first


def test_meter_stream_crosses_from_jax(rng):
    x = _noise(rng, 3, 5 * 9600)
    jm, tm = jl.LoudnessMeter(3, FS), tl.LoudnessMeter(3, FS, device="cpu")
    for k in range(3):
        jm.process(jnp.asarray(x[:, k * 9600:(k + 1) * 9600]))
    tm.state = meter_state_from_jax(jax.tree.map(np.asarray, jm.state),
                                    device="cpu")
    rlb_states = RlbStates()
    _assert_meters_agree(jm, tm, rlb_states)
    for k in range(3, 5):
        jm.process(jnp.asarray(x[:, k * 9600:(k + 1) * 9600]))
        tm.process(torch.from_numpy(x[:, k * 9600:(k + 1) * 9600]))
        _assert_meters_agree(jm, tm, rlb_states)
    rlb_states.check()


def test_true_peak_matches_jax(rng):
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    assert snr_db(np.asarray(jl.true_peak(jnp.asarray(x))),
                  tl.true_peak(torch.from_numpy(x)).numpy()) >= 100.0
    # the inter-sample over of tests/test_loudness.py
    t = np.arange(4800)
    s = np.sin(2 * np.pi * (FS / 4) * t / FS + np.pi / 4)[None]
    s = s.astype(np.float32)
    tp = float(tl.true_peak_db(torch.from_numpy(s))[0])
    assert abs(tp - float(jl.true_peak_db(jnp.asarray(s))[0])) <= 1e-4
    assert tp > 20 * np.log10(np.abs(s).max()) + 0.5 and abs(tp) < 0.35


def _meter_feed(x, nch=2):
    m = tl.LoudnessMeter(nch, FS, device="cpu")
    chunk = int(FS)
    T = x.shape[-1]
    xt = torch.from_numpy(np.ascontiguousarray(x))
    for i in range(0, T - chunk + 1, chunk):
        m.process(xt[:, i:i + chunk])
    rem = (T % chunk) - (T % chunk) % m.step
    if rem:
        m.process(xt[:, T - T % chunk:T - T % chunk + rem])
    return m


# EBU Tech 3341 cases 1-5 (+/-0.1 LU): (segments, expected LUFS, checks);
# "msi" checks momentary, short-term and integrated on the meter, "i"
# integrated on the meter and the one-shot function, "oneshot" the one-shot
# function only
EBU_3341 = {
    1: ([(-23.0, 20.0)], -23.0, "msi"),
    2: ([(-33.0, 20.0)], -33.0, "msi"),
    3: ([(-36.0, 10.0), (-23.0, 60.0), (-36.0, 10.0)], -23.0, "i"),
    4: ([(-72.0, 10.0), (-36.0, 10.0), (-23.0, 60.0), (-36.0, 10.0),
         (-72.0, 10.0)], -23.0, "oneshot"),
    5: ([(-26.0, 20.0), (-20.0, 20.1), (-26.0, 20.0)], -23.0, "i"),
}


@pytest.mark.parametrize("case", [1, 2, 3, 4, 5, 6])
def test_ebu_3341(case):
    """EBU Tech 3341 cases 1-6: every reading within 0.1 LU of the case's
    loudness (-33.0 LUFS in case 2, -23.0 in the others)."""
    if case == 6:
        # 5.0: L, R at -28, C at -24, Ls, Rs at -30 dBFS (surround weights)
        x = np.concatenate([_sine(db, 20.0, nch=1)
                            for db in (-28.0, -28.0, -24.0, -30.0, -30.0)])
        want, checks = -23.0, "i"
    else:
        segs, want, checks = EBU_3341[case]
        x = _seq(*segs)
    readings = [float(tl.integrated_loudness(torch.from_numpy(x), FS))]
    if checks != "oneshot":
        m = _meter_feed(x, x.shape[0])
        readings.append(m.integrated())
        if checks == "msi":
            readings += [m.momentary(), m.short_term()]
    assert all(abs(r - want) <= 0.1 for r in readings), readings


@pytest.mark.parametrize("case,segs,lra", [
    (1, [(-20.0, 20.0), (-30.0, 20.0)], 10.0),
    (2, [(-15.0, 20.0), (-30.0, 20.0)], 15.0),
    (3, [(-40.0, 20.0), (-20.0, 20.0)], 20.0),
    (4, [(-50.0, 20.0), (-35.0, 20.0), (-20.0, 20.0), (-35.0, 20.0),
         (-50.0, 20.0)], 15.0),
])
def test_ebu_3342_lra(case, segs, lra):
    """EBU Tech 3342 cases 1-4: loudness range within +/- 1 LU."""
    got = _meter_feed(_seq(*segs)).loudness_range()
    assert abs(got - lra) <= 1.0, f"case {case}: LRA {got:.2f} != {lra}"
