"""The port's filter bank against the JAX package and the float64 golden
model, and the reference's faults recorded as they are.

The same numpy inputs go through both packages on the CPU.  The banks are
compared where the reference is right: retargets made with ``set_coeffs``.
Output and DF2T registers agree at >= 110 dB (the ramp blocks of both run
at float64 precision, the steady blocks the same modal engine); ``mul`` and
``dec`` are float32 values made by the same float32 operations and agree
to 1e-7; the port's float64 ``targets`` equal the JAX package's ``hi + lo``
pairs to 1e-13.  Against the float64 per-sample DF2T with the
interpolation contract (``golden.biquad_process_interpolated``): >= 90 dB
everywhere, >= 130 dB through the functional core on the hard filters of
``tests/test_dwfloat.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.filters import bank as jbank
from bbcat_dsp_torch.filters import (
    BankState,
    BiQuadFilterBank,
    FilterType,
    bank_init,
    bank_process,
    bank_set_stage,
)
from bbcat_dsp_torch.utils.interop import (
    bank_state_from_jax,
    bank_state_to_jax,
)
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


def peq(freq, gain):
    return golden.biquad_coeffs(FilterType.PEQ, freq, FS, gain=gain)


def assert_states_agree(js, ts: BankState):
    """The port's state against the JAX package's, leaf by leaf."""
    np.testing.assert_allclose(
        ts.targets.numpy(),
        np.asarray(js.targets, np.float64) + np.asarray(js.targets_lo,
                                                        np.float64),
        atol=1e-13)
    np.testing.assert_allclose(
        ts.origins.numpy(),
        np.asarray(js.origins, np.float64) + np.asarray(js.origins_lo,
                                                        np.float64),
        atol=1e-13)
    np.testing.assert_allclose(ts.mul.numpy(), np.asarray(js.mul), atol=1e-7)
    np.testing.assert_allclose(ts.dec.numpy(), np.asarray(js.dec), rtol=1e-7)
    assert snr_db(np.asarray(js.w), ts.w.numpy()) >= 110.0


def both_banks(nstages, nchannels, **kw):
    return (jbank.BiQuadFilterBank(nstages, nchannels, fs=FS, **kw),
            BiQuadFilterBank(nstages, nchannels, fs=FS, device="cpu", **kw))


# ---- the functional core --------------------------------------------------------

def test_bank_init_and_set_stage_match_jax():
    js, ts = jbank.bank_init(3, 2), bank_init(3, 2, device="cpu")
    assert ts.targets.dtype == ts.origins.dtype == torch.float64
    assert ts.mul.dtype == ts.dec.dtype == ts.w.dtype == torch.float32
    assert ts.w.shape == (3, 2, 2)
    assert_states_agree(js, ts)
    for stage, c, n in ((0, peq(500, 5), 0), (2, peq(900, -3), 0),
                        (0, peq(700, -4), 600.0), (0, peq(650, 2), 77.5)):
        js = jbank.bank_set_stage(js, stage, c, n)
        ts = bank_set_stage(ts, stage, c, n)
        assert_states_agree(js, ts)


@pytest.mark.parametrize("engine,floor", [("scan", 90.0), ("assoc", 90.0),
                                          ("assoc_dw", 130.0)])
def test_bank_process_ramp_vs_golden_and_jax(rng, engine, floor):
    """``tests/test_filters.py::test_interpolated_coeffs_vs_golden``: a
    ramp of 400 samples inside a block of 600, on every companion engine,
    then a second block; against float64 and the JAX core."""
    c_old, c_new = peq(1000, 0), peq(1000, 9)
    x = rng.standard_normal((2, 900)).astype(np.float32)
    ref = np.stack([golden.biquad_process_interpolated(
        row, c_old, c_new, 400)[0] for row in x])
    js, ts = jbank.bank_init(1, 2), bank_init(1, 2, device="cpu")
    js = jbank.bank_set_stage(jbank.bank_set_stage(js, 0, c_old, 0), 0,
                              c_new, 400)
    ts = bank_set_stage(bank_set_stage(ts, 0, c_old, 0), 0, c_new, 400)
    for sl in (slice(0, 600), slice(600, 900)):
        js, jy = jbank.bank_process(js, jnp.asarray(x[:, sl]), engine=engine)
        ts, ty = bank_process(ts, torch.from_numpy(x[:, sl]), engine=engine)
        assert snr_db(ref[:, sl], ty.numpy()) > floor
        # the float32 engines take the trajectory rounded from float64
        # here and interpolated in float32 there, and the parallel scans
        # associate differently besides: each within 90 dB of float64, so
        # >= 80 dB of each other (measured 85.6); the sequential engines
        # >= 100 dB; the float64 one >= 110 dB, its state too
        assert snr_db(np.asarray(jy), ty.numpy()) >= {
            "assoc": 80.0, "scan": 100.0, "assoc_dw": 110.0}[engine]
        assert float(ts.mul[0]) == 0.0 == float(js.mul[0])
    if engine == "assoc_dw":
        assert_states_agree(js, ts)


def test_bank_ramp_meets_the_double_word_bar_on_a_hard_filter():
    """``tests/test_dwfloat.py::test_bank_ramp_uses_dw_and_matches_golden``
    on the port: an HPF12 retuned from 80 to 40 Hz over a block of 2048,
    > 130 dB against the float64 loop (measured 148.8 dB)."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((1, 2048))
    c0 = golden.biquad_coeffs(FilterType.HPF12, 80.0, FS)
    c1 = golden.biquad_coeffs(FilterType.HPF12, 40.0, FS)
    st = bank_set_stage(bank_set_stage(bank_init(1, 1, device="cpu"), 0, c0),
                        0, c1, 2048)
    st, y = bank_process(st, torch.from_numpy(x.astype(np.float32)),
                         engine="assoc_dw")
    g = golden.biquad_process_interpolated(x[0], c0, c1, 2048)[0]
    assert snr_db(g, y.numpy()[0]) > 130.0
    assert float(st.mul[0]) == 0.0


def test_retarget_in_the_middle_of_a_ramp_starts_from_the_coefficients_in_effect(rng):
    """A second target set after 150 of 400 ramp samples: the new ramp's
    origin is the interpolated coefficient vector, to float64 rounding."""
    c0, c1, c2 = peq(1000, 0), peq(1000, 9), peq(2000, -6)
    ts = bank_set_stage(bank_set_stage(bank_init(1, 1, device="cpu"), 0, c0),
                        0, c1, 400)
    ts, _ = bank_process(ts, torch.zeros(1, 150), engine="scan")
    ts = bank_set_stage(ts, 0, c2, 100)
    dec = float(np.float32(1.0 / 400))
    mul = float(np.float32(np.float32(1.0) - np.float32(dec) * 150))
    np.testing.assert_allclose(ts.origins.numpy()[0], c1 - mul * (c1 - c0),
                               atol=1e-15)
    np.testing.assert_array_equal(ts.targets.numpy()[0], c2)
    assert float(ts.mul[0]) == 1.0


# ---- the class ------------------------------------------------------------------

def test_bank_streams_through_a_set_coeffs_ramp_and_the_handover_like_jax(rng):
    """Two stages over three channels, blocks of 256: steady (modal), a
    ramp of 600 samples on stage 0 set before block 2, a second of 300 on
    stage 1 before block 3, the handover back to the modal engine after
    block 4, steady again.  Output, state and the engine taken agree block
    by block; the output holds 90 dB against the float64 loop."""
    C, B, nblk = 3, 256, 8
    c0, c1, c2 = peq(500, 5), golden.biquad_coeffs(
        FilterType.HSH, 8000, FS, gain=-6), peq(700, -4)
    jb, tb = both_banks(2, C)
    for b in (jb, tb):
        b.set_coeffs(0, c0)
        b.set_coeffs(1, c1)
    x = rng.standard_normal((C, nblk * B)).astype(np.float32)
    ys = []
    for k in range(nblk):
        if k == 2:
            for b in (jb, tb):
                b.set_coeffs(0, c2, 600.0)
        if k == 3:
            for b in (jb, tb):
                b.set_coeffs(1, c0, 300.0)
        sl = slice(k * B, (k + 1) * B)
        jy = np.asarray(jb.process(jnp.asarray(x[:, sl])))
        ty = tb.process(torch.from_numpy(x[:, sl])).numpy()
        ys.append(ty)
        assert snr_db(jy, ty) >= 110.0, k
        assert (jb._modal is None) == (tb._modal is None), k
        assert jb._ramp_remaining == tb._ramp_remaining, k
        assert_states_agree(jb.state, tb.state)
    assert tb._modal is not None
    # float64: stage 0 ramps c0 -> c2 from sample 512, stage 1 c1 -> c0
    # from sample 768
    y = np.concatenate(ys, -1)
    for ch in range(C):
        s0 = golden.biquad_process_interpolated(x[ch, :512], c0, c0, 0)
        a = np.r_[s0[0], golden.biquad_process_interpolated(
            x[ch, 512:], c0, c2, 600.0, state=s0[1])[0]]
        s1 = golden.biquad_process_interpolated(a[:768], c1, c1, 0)
        ref = np.r_[s1[0], golden.biquad_process_interpolated(
            a[768:], c1, c0, 300.0, state=s1[1])[0]]
        assert snr_db(ref, y[ch]) > 90.0


def test_bank_class_ramp_then_steady_on_a_hard_filter():
    """``tests/test_dwfloat.py::test_bank_class_ramp_then_steady`` on the
    port: a float64 ramp block, then modal blocks, > 110 dB."""
    rng = np.random.default_rng(42)
    C, B = 4, 512
    x = rng.standard_normal((C, 3 * B))
    bank = BiQuadFilterBank(1, C, device="cpu")
    bank.set_filter(0, FilterType.HPF12, 80.0)
    bank.set_filter(0, FilterType.HPF12, 40.0, interp_time=B / FS)
    y = torch.cat([bank.process(x[:, k * B:(k + 1) * B].astype(np.float32))
                   for k in range(3)], -1).numpy()
    c0 = golden.biquad_coeffs(FilterType.HPF12, 80.0, FS)
    c1 = golden.biquad_coeffs(FilterType.HPF12, 40.0, FS)
    g = np.stack([golden.biquad_process_interpolated(x[c], c0, c1, float(B))[0]
                  for c in range(C)])
    assert snr_db(g, y) > 110.0


def test_set_filter_retargets_a_steady_bank_in_the_port_and_not_in_jax(rng):
    """The reference's ``set_filter`` calls ``bank_set_stage`` directly: on
    a bank that has processed a block it neither folds the modal state back
    nor leaves the modal branch, so the retarget never reaches the audio
    (its output equals that of a bank never retargeted, difference 0.0).
    The port's goes through ``set_coeffs`` and follows the float64 ramp."""
    C, B = 2, 512
    x = rng.standard_normal((C, 4 * B)).astype(np.float32)

    def run(bank, retarget, to_in, to_out):
        bank.set_filter(0, FilterType.PEQ, 3000.0, gain=4.0)
        ys = []
        for k in range(4):
            if k == 2 and retarget:
                bank.set_filter(0, FilterType.PEQ, 3000.0, gain=-6.0,
                                interp_time=300 / FS)
            ys.append(to_out(bank.process(to_in(x[:, k * B:(k + 1) * B]))))
        return np.concatenate(ys, -1)

    def jrun(retarget):
        return run(jbank.BiQuadFilterBank(1, C, fs=FS), retarget,
                   jnp.asarray, np.asarray)

    def trun(retarget):
        return run(BiQuadFilterBank(1, C, fs=FS, device="cpu"), retarget,
                   torch.from_numpy, lambda t: t.numpy())

    assert float(np.abs(jrun(True) - jrun(False)).max()) == 0.0
    y = trun(True)
    assert float(np.abs(y - trun(False)).max()) > 1.0
    c0, c1 = peq(3000.0, 4.0), peq(3000.0, -6.0)
    for ch in range(C):
        s0 = golden.biquad_process_interpolated(x[ch, :2 * B], c0, c0, 0)
        ref = np.r_[s0[0], golden.biquad_process_interpolated(
            x[ch, 2 * B:], c0, c1, 300.0, state=s0[1])[0]]
        assert snr_db(ref, y[ch]) > 90.0


def test_a_ramp_set_by_set_filter_on_a_fresh_bank_keeps_the_ramp_engine_until_it_lands(rng):
    """The other half of the same fault: on a fresh JAX bank a ramp set by
    ``set_filter`` leaves ``_ramp_remaining`` at 0, so the first block
    hands over to the modal engine at the targets while ``mul`` is still
    above 0.  The port stays on the ramp engine until the ramp has
    landed."""
    C, B = 2, 256
    x = rng.standard_normal((C, 4 * B)).astype(np.float32)
    jb, tb = both_banks(1, C)
    for b in (jb, tb):
        b.set_filter(0, FilterType.PEQ, 1000.0, gain=0.0)
        b.set_filter(0, FilterType.PEQ, 1000.0, gain=9.0,
                     interp_time=600 / FS)
    ys = []
    for k in range(4):
        sl = slice(k * B, (k + 1) * B)
        jb.process(jnp.asarray(x[:, sl]))
        ys.append(tb.process(torch.from_numpy(x[:, sl])).numpy())
        if k == 0:
            assert jb._modal is not None and float(jb.state.mul[0]) > 0.5
            assert tb._modal is None and float(tb.state.mul[0]) > 0.5
    assert tb._modal is not None and float(tb.state.mul[0]) == 0.0
    y = np.concatenate(ys, -1)
    for ch in range(C):
        ref = golden.biquad_process_interpolated(
            x[ch], peq(1000.0, 0.0), peq(1000.0, 9.0), 600.0)[0]
        assert snr_db(ref, y[ch]) > 90.0


def test_a_fractional_ramp_length_hands_over_after_landing_in_the_port_and_before_in_jax(rng):
    """``set_coeffs`` in the reference keeps ``int(interp_samples)``
    samples of ramp: a ramp of 256.5 samples ends, by that count, with the
    first block of 256, and the bank hands over to the modal engine at the
    targets with ``mul`` still a hair above 0 (it lands one sample later).
    The port counts ``ceil``: the second block still runs the ramp engine,
    the ramp lands in it, and the output follows the float64 loop."""
    C, B = 2, 256
    x = rng.standard_normal((C, 3 * B)).astype(np.float32)
    jb, tb = both_banks(1, C)
    for b in (jb, tb):
        b.set_coeffs(0, peq(1000.0, 0.0))
        b.set_coeffs(0, peq(1000.0, 12.0), 256.5)
    ys = []
    for k in range(3):
        sl = slice(k * B, (k + 1) * B)
        jb.process(jnp.asarray(x[:, sl]))
        ys.append(tb.process(torch.from_numpy(x[:, sl])).numpy())
        if k == 0:
            assert jb._modal is not None and float(jb.state.mul[0]) > 0.0
            assert tb._modal is None and float(tb.state.mul[0]) > 0.0
        if k == 1:
            assert tb._modal is not None and float(tb.state.mul[0]) == 0.0
    y = np.concatenate(ys, -1)
    for ch in range(C):
        ref = golden.biquad_process_interpolated(
            x[ch], peq(1000.0, 0.0), peq(1000.0, 12.0), 256.5)[0]
        assert snr_db(ref, y[ch]) > 90.0


def test_snapshot_and_restore_resume_a_bank(rng):
    """A bank stopped on a steady block and one stopped in the middle of a
    ramp, each continued in a fresh bank from ``snapshot`` through
    ``restore``: the joined output against the uninterrupted run at >= 110
    dB, and the restored bank back on the modal engine once the ramp has
    landed."""
    C, B = 2, 256
    x = torch.from_numpy(rng.standard_normal((C, 8 * B)).astype(np.float32))

    def fresh():
        bank = BiQuadFilterBank(2, C, fs=FS, device="cpu")
        bank.set_coeffs(0, peq(500, 5))
        bank.set_coeffs(1, peq(4000, -3))
        return bank

    def stream(bank, lo, hi):
        out = []
        for k in range(lo, hi):
            if k == 4:
                bank.set_coeffs(0, peq(800, -6), 700.0)
            out.append(bank.process(x[:, k * B:(k + 1) * B]))
        return torch.cat(out, -1)

    whole = stream(fresh(), 0, 8).numpy()
    for stop in (3, 5):          # steady; 256 samples into the ramp
        a = fresh()
        y1 = stream(a, 0, stop)
        assert (a._modal is None) == (stop == 5)
        b = BiQuadFilterBank(2, C, fs=FS, device="cpu")
        b.restore(a.snapshot())
        assert b._ramp_remaining == (444 if stop == 5 else 0)
        y2 = stream(b, stop, 8)
        assert b._modal is not None
        assert snr_db(whole, torch.cat([y1, y2], -1).numpy()) >= 110.0


def test_response_and_copy_audio_state(rng):
    jb, tb = both_banks(2, 2)
    for b in (jb, tb):
        b.set_coeffs(0, peq(500, 5))
        b.set_coeffs(1, peq(4000, -3))
        b.set_coeffs(1, peq(4000, 6), 512.0)
    x = rng.standard_normal((2, 128)).astype(np.float32)
    jb.process(jnp.asarray(x))
    tb.process(torch.from_numpy(x))
    f = np.array([100.0, 500.0, 4000.0])
    # the JAX package evaluates its float32 planes: 1e-4 of the response
    for usetargets in (True, False):
        np.testing.assert_allclose(tb.calc_response(f, usetargets),
                                   jb.calc_response(f, usetargets), rtol=1e-4)
    other = BiQuadFilterBank(2, 2, fs=FS, device="cpu")
    other.copy_audio_state(tb)
    assert torch.equal(other.state.w, tb.state.w)


def test_bank_state_converters_round_trip(rng):
    """``bank_state_to_jax`` splits float64 into ``hi + lo`` float32 pairs
    whose sum is the float64 value to 2^-48; ``bank_state_from_jax`` sums
    them."""
    ts = bank_init(2, 3, device="cpu")
    ts = bank_set_stage(ts, 0, peq(500, 5))
    ts = bank_set_stage(ts, 1, peq(1234.5, -7), 300.0)
    leaves = bank_state_to_jax(ts)
    assert list(leaves) == list(jbank.BankState._fields)
    assert all(v.dtype == np.float32 for v in leaves.values())
    back = bank_state_from_jax(jbank.BankState(**leaves), device="cpu")
    for name in ("targets", "origins"):
        a, b = getattr(ts, name).numpy(), getattr(back, name).numpy()
        assert np.abs(a - b).max() <= 2.0 ** -48 * np.abs(a).max()
    for name in ("mul", "dec", "w"):
        assert torch.equal(getattr(ts, name), getattr(back, name))
