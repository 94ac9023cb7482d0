"""The port's companion-form IIR engines, cascade and ``FilterManager``
against the JAX package and the float64 golden model.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Tolerances, each stated where it is used:

* against the float64 golden DF2T (``golden/biquad.py``): >= 90 dB, the
  bar of ``tests/test_filters.py``;
* the sequential engines of the two packages do the same float32
  operations in the same order (XLA may fuse a multiply and an add): >=
  110 dB on output and state;
* the parallel engines associate their 2 x 2 products in different
  orders (Hillis-Steele doubling here, ``associative_scan``'s tree
  there), so they agree with each other as each agrees with float64: >=
  90 dB;
* the float64 engine (``assoc_dw``) on filters with poles within 1e-4 of
  the unit circle: >= 130 dB against a float64 per-sample loop, the bar
  the JAX package's double-word engine is held to in
  ``tests/test_dwfloat.py`` (measured 148.9 dB).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.filters import iir as jiir
from bbcat_dsp_tpu.filters import manager as jmanager
from bbcat_dsp_tpu.utils.dwfloat import dw_from_f64
from bbcat_dsp_torch.filters import (
    BiQuadBlock,
    BiQuadCascade,
    FilterManager,
    FilterType,
    biquad_apply,
    biquad_coeffs,
    biquad_ssm,
    cascade_apply,
    interp_trajectory,
    modal_apply,
    modal_from_df2t,
    modal_params,
)
from bbcat_dsp_torch.filters import iir as tiir
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


def hard_ramp_case(rng, C=8, T=2048):
    """The hard filters of ``tests/test_dwfloat.py``: a low HPF12 retuned
    from 80 to 40 Hz, poles within 1e-4 of the unit circle, one ramp over
    the whole block.  ``(x, c0, c1, trajectory [C, T, 5] float64, golden
    output)``."""
    x = rng.standard_normal((C, T))
    c0 = np.stack([golden.biquad_coeffs(FilterType.HPF12, 80.0 + 0.5 * i, FS)
                   for i in range(C)])
    c1 = np.stack([golden.biquad_coeffs(FilterType.HPF12, 40.0 + 0.5 * i, FS)
                   for i in range(C)])
    mul = np.maximum(1.0 - np.arange(T) / T, 0.0)
    traj = c1[:, None, :] - mul[None, :, None] * (c1 - c0)[:, None, :]
    g = np.stack([golden.biquad_process_interpolated(x[c], c0[c], c1[c], T)[0]
                  for c in range(C)])
    return x, c0, c1, traj, g


# ---- one biquad ---------------------------------------------------------------

def test_biquad_ssm_matches_jax(rng):
    c = rng.standard_normal((3, 4, 5)).astype(np.float32)
    want = jiir.biquad_ssm(jnp.asarray(c))
    got = biquad_ssm(torch.from_numpy(c))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("engine,vs_jax", [("scan", 110.0), ("assoc", 90.0)])
def test_biquad_static_vs_golden_and_jax(rng, engine, vs_jax):
    c = golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=6, bandwidth=1)
    c32 = c.astype(np.float32)
    x = rng.standard_normal(2048).astype(np.float32)
    y_ref, _ = golden.biquad_process(x, c)
    jy, js = jiir.biquad_apply(jnp.asarray(x), jnp.asarray(c32), engine=engine)
    ty, ts = biquad_apply(torch.from_numpy(x), torch.from_numpy(c32),
                          engine=engine)
    assert ty.dtype == torch.float32 and ts.shape == (2,)
    assert snr_db(y_ref, ty.numpy()) > 90.0
    assert snr_db(np.asarray(jy), ty.numpy()) >= vs_jax
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("engine,vs_jax", [("scan", 110.0), ("assoc", 90.0),
                                           ("assoc_dw", 120.0)])
def test_biquad_trajectory_vs_golden_and_jax(rng, engine, vs_jax):
    """A ramp of 400 samples inside a block of 600, coefficients ``[1, T,
    5]`` over 3 channels."""
    c_old = golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=0)
    c_new = golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=9)
    x = rng.standard_normal((3, 600)).astype(np.float32)
    ref = np.stack([golden.biquad_process_interpolated(
        row, c_old, c_new, 400)[0] for row in x])
    traj, mul = interp_trajectory(c_old, c_new, 1.0, 1.0 / 400, 600,
                                  device="cpu")
    jtraj, jmul = jiir.interp_trajectory(
        jnp.asarray(c_old, jnp.float32), jnp.asarray(c_new, jnp.float32),
        jnp.float32(1.0), jnp.float32(1.0 / 400), 600)
    assert traj.dtype == torch.float64 and traj.shape == (600, 5)
    assert float(mul) == 0.0 == float(jmul)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-6)
    if engine == "assoc_dw":
        # float64 here, pairs of float32 there, from the same float64 values
        tc, jc = traj[None], jiir.DWCoeffs(*dw_from_f64(traj.numpy()[None]))
    else:
        # the same float32 trajectory through both
        tc, jc = torch.from_numpy(np.array(jtraj))[None], jtraj[None]
    ty, ts = biquad_apply(torch.from_numpy(x), tc, engine=engine)
    # >= 90 dB against float64; the float64 engine far above it
    assert snr_db(ref, ty.numpy()) > (130.0 if engine == "assoc_dw" else 90.0)
    jy, js = jiir.biquad_apply(jnp.asarray(x), jc, engine=engine)
    assert snr_db(np.asarray(jy), ty.numpy()) >= vs_jax
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("engine,floor", [("scan", 120.0), ("assoc", 80.0),
                                          ("assoc_dw", 120.0)])
def test_streaming_equals_one_shot_with_the_final_state(rng, engine, floor):
    """Four blocks of 256 against one call of 1024, the floors of
    ``tests/test_filters.py`` (the parallel scan associates differently
    across a block boundary)."""
    c = golden.biquad_coeffs(FilterType.LSH, 300, FS, gain=-4)
    coeffs = np.broadcast_to(c, (1024, 5)).copy()   # a constant trajectory
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    y_full, s_full = biquad_apply(x, coeffs[None], engine=engine)
    s, outs = None, []
    for i in range(4):
        sl = slice(i * 256, (i + 1) * 256)
        y, s = biquad_apply(x[:, sl], coeffs[None, sl], s, engine=engine)
        outs.append(y)
    assert snr_db(y_full.numpy(), torch.cat(outs, -1).numpy()) > floor
    np.testing.assert_allclose(s.numpy(), s_full.numpy(), atol=1e-4)


def test_float64_engine_meets_the_double_word_bar_on_hard_filters(rng):
    """What ``tests/test_dwfloat.py::
    test_assoc_dw_matches_f64_golden_on_hard_filters`` holds the JAX
    package's double-word engine to (> 130 dB, and plain float32 far
    short), on the same filters: float64 needs no double-word
    arithmetic."""
    x, _, _, traj, g = hard_ramp_case(np.random.default_rng(42))
    x32 = torch.from_numpy(x.astype(np.float32))
    y, _ = biquad_apply(x32, traj, engine="assoc_dw")
    assert y.dtype == torch.float32
    assert snr_db(g, y.numpy()) > 130.0
    y32, _ = biquad_apply(x32, torch.from_numpy(traj.astype(np.float32)),
                          engine="assoc")
    assert snr_db(g, y32.numpy()) < 110.0


def test_float64_engine_streams_on_hard_filters(rng):
    """``test_assoc_dw_streaming_state_handover``: four blocks against one
    call, > 125 dB against float64 and > 120 dB against each other, the
    state rounded to float32 at every block boundary."""
    x, _, _, traj, g = hard_ramp_case(np.random.default_rng(42), C=4, T=1024)
    x32 = torch.from_numpy(x.astype(np.float32))
    y_full, _ = biquad_apply(x32, traj, engine="assoc_dw")
    s, outs = None, []
    for k in range(4):
        sl = slice(k * 256, (k + 1) * 256)
        y, s = biquad_apply(x32[:, sl], traj[:, sl], s, engine="assoc_dw")
        outs.append(y)
    y_stream = torch.cat(outs, -1).numpy()
    assert snr_db(g, y_stream) > 125.0
    assert snr_db(y_full.numpy(), y_stream) > 120.0


@pytest.mark.parametrize("name,c", [
    ("PEQ 1 kHz", golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=6)),
    ("LSH 200 Hz", golden.biquad_coeffs(FilterType.LSH, 200, FS, gain=3)),
    ("RLB", golden.k_weighting_coeffs(FS)[1]),
])
def test_two_level_scan_buys_at_most_3_db(rng, name, c):
    """The JAX package's two levels (chunks of 128, then the chunks'
    carries) against one flat scan, float32, T = 4096, both against
    float64: within 3 dB of each other on every filter (measured 0.0, 0.1
    and 1.7 dB), so the port scans flat."""
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    ref = np.stack([golden.biquad_process(row, c)[0] for row in x])
    c32 = torch.from_numpy(c.astype(np.float32))
    snr = []
    for chunk in (None, 128):
        y, s = tiir._apply_assoc(torch.from_numpy(x), c32, torch.zeros(2, 2),
                                 False, torch.float32, chunk)
        snr.append(snr_db(ref, y.numpy()))
    assert abs(snr[0] - snr[1]) < 3.0
    # and in float64 both are exact
    y64 = [tiir._apply_assoc(torch.from_numpy(x), torch.from_numpy(c),
                             torch.zeros(2, 2), False, torch.float64, k)[0]
           for k in (None, 128)]
    assert snr_db(y64[0].numpy(), y64[1].numpy()) > 140.0


@pytest.mark.parametrize("T", [1, 2, 129, 300])
def test_assoc_at_lengths_off_the_chunks(rng, T):
    """Flat and two-level scans at lengths that are no multiple of the
    chunk, against the sequential engine."""
    c = golden.biquad_coeffs(FilterType.PEQ, 3000, FS, gain=-5)
    x = torch.from_numpy(rng.standard_normal((2, T)))
    s0 = torch.from_numpy(rng.standard_normal((2, 2)))
    want, ws = biquad_apply(x, torch.from_numpy(c), s0, engine="scan")
    for chunk in (None, 128, 7):
        y, s = tiir._apply_assoc(x, torch.from_numpy(c), s0, False,
                                 torch.float64, chunk)
        np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-12)
        np.testing.assert_allclose(s.numpy(), ws.numpy(), atol=1e-12)


def test_auto_engine_rule(rng):
    """Static coefficients given on the host take the modal engine (a
    ``ModalState`` comes back), a trajectory or a tensor the companion
    scan (``[..., 2]`` registers)."""
    c = golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=6)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    _, s = biquad_apply(x, c)
    assert isinstance(s, tiir.ModalState)
    _, s = biquad_apply(x, list(c))
    assert isinstance(s, tiir.ModalState)
    _, s = biquad_apply(x, torch.from_numpy(c))
    assert s.shape == (2, 2)
    _, s = biquad_apply(x, np.broadcast_to(c, (1, 64, 5)))
    assert s.shape == (2, 2)
    _, s = biquad_apply(x, modal_params(c, device="cpu"))
    assert isinstance(s, tiir.ModalState)
    with pytest.raises(ValueError):
        biquad_apply(x, np.broadcast_to(c, (1, 64, 5)), engine="modal")
    with pytest.raises(ValueError):
        biquad_apply(x, c, engine="assoc_dw")
    with pytest.raises(ValueError):
        biquad_apply(x, c, engine="nope")
    with pytest.raises(ValueError):
        biquad_apply(x, modal_params(c, device="cpu"), engine="scan")


@pytest.mark.parametrize("engine", ["modal", "assoc", "scan"])
def test_float64_input_runs_in_float64(rng, engine):
    """``dtype`` is widened here: a float64 signal comes back float64 and
    agrees with the golden model to rounding."""
    c = golden.biquad_coeffs(FilterType.LSH, 200.0, FS, gain=3.0)
    x = rng.standard_normal(1500)
    ref, _ = golden.biquad_process(x, c)
    y, _ = biquad_apply(torch.from_numpy(x), c, engine=engine)
    assert y.dtype == torch.float64
    assert snr_db(ref, y.numpy()) > 200.0


def test_high_q_filter_through_auto(rng):
    """``tests/test_filters.py::test_high_q_filter_snr``: the RLB filter
    over a second of noise, > 90 dB, and >= 110 dB against JAX (both take
    the modal engine's Toeplitz products)."""
    c = golden.k_weighting_coeffs(FS)[1]
    x = rng.standard_normal(48000).astype(np.float32)
    y_ref, _ = golden.biquad_process(x, c)
    y, _ = biquad_apply(torch.from_numpy(x), c)
    jy, _ = jiir.biquad_apply(jnp.asarray(x), c)
    assert snr_db(y_ref, y.numpy()) > 90.0
    assert snr_db(np.asarray(jy), y.numpy()) >= 110.0


# ---- the five pole cases of the realization change -----------------------------

POLE_CASES = {
    "complex pair": golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=6),
    "real distinct": golden.biquad_coeffs(FilterType.LSH, 200, FS, gain=3),
    "repeated": golden.biquad_coeffs(FilterType.HPF12, 80, FS),
    "p2 == 0": golden.biquad_coeffs(FilterType.HPF6, 50, FS),
    "all zero": golden.biquad_coeffs(FilterType.FLAT, 50, FS),
}


@pytest.mark.parametrize("case", list(POLE_CASES))
def test_modal_from_df2t_pole_cases(rng, case):
    """DF2T registers reached by filtering noise (in float64, rounded to
    float32), converted, and the stream continued in the modal engine: the
    joined output against one float64 DF2T run at >= 100 dB, and the
    converted state against the JAX package's (1e-4 of the state's scale:
    the real-distinct case divides by ``p1 - p2``)."""
    c = POLE_CASES[case]
    x = rng.standard_normal((3, 700)).astype(np.float32)
    ref = np.stack([golden.biquad_process(row, c)[0] for row in x])
    y1, w = biquad_apply(torch.from_numpy(x[:, :300]).double(),
                         torch.from_numpy(c), engine="scan")
    y1, w = y1.float(), w.float()
    tp, jp = modal_params(c, device="cpu"), jiir.modal_params(c)
    ts = modal_from_df2t(tp, w)
    js = jiir.modal_from_df2t(jp, jnp.asarray(w.numpy()))
    scale = max(1.0, max(float(np.abs(np.asarray(a)).max()) for a in js))
    for name, want, got in zip(ts._fields, js, ts):
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4 * scale, err_msg=name)
    y2, _ = modal_apply(torch.from_numpy(x[:, 300:]), tp, ts)
    assert snr_db(ref, torch.cat([y1, y2], -1).numpy()) >= 100.0


# ---- cascades -----------------------------------------------------------------

CASCADE = np.stack([
    golden.biquad_coeffs(FilterType.HPF12, 80, FS),
    golden.biquad_coeffs(FilterType.PEQ, 400, FS, gain=-3, bandwidth=1.5),
    golden.biquad_coeffs(FilterType.PEQ, 2500, FS, gain=4, bandwidth=0.8),
    golden.biquad_coeffs(FilterType.HSH, 9000, FS, gain=2),
])


@pytest.mark.parametrize("engine,vs_jax", [
    ("auto", 110.0), ("parallel", 110.0), ("scan", 100.0), ("assoc", 90.0)])
def test_cascade_vs_golden_and_jax(rng, engine, vs_jax):
    """Two calls of 4096 samples.  The modal engine takes the whole
    cascade as the float64 design.  The HPF12 at 80 Hz is left out of the
    other engines' cascade: its repeated pole has no parallel form, and it
    caps a float32 companion form near 60 dB in either package.  Three
    sequential float32 stages, with XLA free to fuse a multiply into an
    add, agree at >= 100 dB (measured 106.3)."""
    stages = CASCADE if engine == "auto" else CASCADE[1:]
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    ref = np.stack([golden.cascade_process(row, stages)[0] for row in x])
    host = engine in ("auto", "parallel")
    tc = stages if host else torch.from_numpy(stages.astype(np.float32))
    jc = stages if host else jnp.asarray(stages, jnp.float32)
    ts = js = None
    for sl in (slice(0, 4096), slice(4096, 8192)):
        ty, ts = cascade_apply(torch.from_numpy(x[:, sl]), tc, ts,
                               engine=engine)
        jy, js = jiir.cascade_apply(jnp.asarray(x[:, sl]), jc, js,
                                    engine=engine)
        assert snr_db(ref[:, sl], ty.numpy()) > 90.0
        assert snr_db(np.asarray(jy), ty.numpy()) >= vs_jax
    if engine == "parallel":
        with pytest.raises(ValueError):
            cascade_apply(torch.from_numpy(x), CASCADE, engine="parallel")


def test_cascade_systolic_is_the_serial_cascade_delayed(rng):
    coeffs = np.stack([
        golden.biquad_coeffs(FilterType.LPF12, 5000, FS),
        golden.biquad_coeffs(FilterType.PEQ, 1000, FS, gain=3),
        golden.biquad_coeffs(FilterType.HPF6, 50, FS),
    ])
    x = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    c = torch.from_numpy(coeffs.astype(np.float32))
    y_ser, _ = cascade_apply(x, c)
    y_sys, _ = cascade_apply(x, c, systolic=True)
    S = coeffs.shape[0]
    assert snr_db(y_ser.numpy()[:1024 - (S - 1)], y_sys.numpy()[S - 1:]) > 90.0
    jy, _ = jiir.cascade_apply(jnp.asarray(x.numpy()),
                               jnp.asarray(coeffs, jnp.float32), systolic=True)
    assert snr_db(np.asarray(jy), y_sys.numpy()) >= 100.0
    with pytest.raises(ValueError):
        cascade_apply(x, coeffs, engine="parallel", systolic=True)


def test_cascade_classes(rng):
    """``BiQuadCascade`` from both coefficient layouts, systolic, and
    ``BiQuadBlock``, against the golden cascade."""
    g = 0.5
    rows = CASCADE[1:].copy()
    rows[:, :3] /= rows[:, :1]            # b0 = 1: the split layout's form
    b1, b2, a1, a2 = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
    want = rows.copy()
    want[0, :3] *= g
    x = rng.standard_normal(2048).astype(np.float32)
    ref, _ = golden.cascade_process(x, want)
    inter = np.r_[g, np.stack([b1, b2, a1, a2], -1).reshape(-1)]
    for casc in (BiQuadCascade.from_split(g, b1, b2, a1, a2, device="cpu"),
                 BiQuadCascade.from_interleaved(inter, device="cpu")):
        np.testing.assert_allclose(casc.coeffs_host, want, rtol=1e-15)
        y = torch.cat([casc.process(x[:1024]), casc.process(x[1024:])])
        assert y.shape == (2048,) and snr_db(ref, y.numpy()) > 90.0
        casc.reset()
        assert snr_db(ref[:1024], casc.process(x[:1024]).numpy()) > 90.0
    np.testing.assert_allclose(
        casc.calc_response(np.array([100.0, 1000.0])),
        golden.biquad_response(want[0], np.array([100.0, 1000.0]), FS)
        * golden.biquad_response(want[1], np.array([100.0, 1000.0]), FS)
        * golden.biquad_response(want[2], np.array([100.0, 1000.0]), FS))
    with pytest.raises(ValueError):
        BiQuadCascade.from_interleaved(np.ones(6), device="cpu")
    sysc = BiQuadCascade(want, systolic=True, engine="assoc", device="cpu")
    assert snr_db(ref[:-2], sysc.process(x).numpy()[2:]) > 90.0

    blk = BiQuadBlock(CASCADE[1:2], nchannels=2, block_size=256, device="cpu")
    x2 = rng.standard_normal((2, 512)).astype(np.float32)
    y = torch.cat([blk.process_block(x2[:, :256]),
                   blk.process_block(x2[:, 256:])], -1).numpy()
    for c in range(2):
        assert snr_db(golden.cascade_process(x2[c], CASCADE[1:2])[0],
                      y[c]) > 90.0
    with pytest.raises(ValueError):
        blk.process_block(x2[:, :100])


# ---- FilterManager --------------------------------------------------------------

MUSIC_JSON = json.dumps(
    {"music": {"stages": [{"type": "LSH", "freq": 200, "gain": 3}]}})


def managers():
    jm = jmanager.FilterManager(fs=FS)
    tm = FilterManager(fs=FS, device="cpu")
    for fm in (jm, tm):
        fm.define("voice", [(FilterType.HPF12, 120.0),
                            (FilterType.PEQ, 3000.0, 4.0)])
        fm.define_from_json(MUSIC_JSON)
        fm.assign_range([0, 1], "voice")
        fm.assign(2, "music")
    return jm, tm


def test_filter_manager(rng):
    """As ``tests/test_filters.py::test_filter_manager``, and against the
    JAX manager at >= 110 dB over two calls."""
    jm, tm = managers()
    assert tm.names() == ["music", "voice"]
    x = rng.standard_normal((4, 512)).astype(np.float32)
    y = tm.process(torch.from_numpy(x)).numpy()
    jy = np.asarray(jm.process(jnp.asarray(x)))
    voice = np.stack([golden.biquad_coeffs(FilterType.HPF12, 120.0, FS),
                      golden.biquad_coeffs(FilterType.PEQ, 3000.0, FS,
                                           gain=4.0)])
    music = np.stack([golden.biquad_coeffs(FilterType.LSH, 200.0, FS,
                                           gain=3.0)])
    for c in (0, 1):
        assert snr_db(golden.cascade_process(x[c], voice)[0], y[c]) > 90.0
    assert snr_db(golden.cascade_process(x[2], music)[0], y[2]) > 90.0
    np.testing.assert_array_equal(y[3], x[3])     # unassigned: untouched
    assert snr_db(jy, y) >= 110.0
    assert abs(tm.response("voice", np.array([50.0]))[0]) < 0.3
    np.testing.assert_allclose(tm.response("voice", np.array([50.0, 900.0])),
                               jm.response("voice", np.array([50.0, 900.0])))
    y2 = tm.process(torch.from_numpy(x)).numpy()
    ref2, _ = golden.cascade_process(np.concatenate([x[0], x[0]]), voice)
    assert snr_db(ref2[512:], y2[0]) > 90.0
    assert snr_db(np.asarray(jm.process(jnp.asarray(x))), y2) >= 110.0
    tm.reset()
    assert snr_db(y, tm.process(torch.from_numpy(x)).numpy()) > 140.0
    with pytest.raises(KeyError):
        tm.assign(0, "nope")


def test_filter_manager_fewer_channels_than_assigned(rng):
    """A block with fewer channels than are assigned: the channels beyond
    it are left out, in both packages."""
    jm, tm = managers()
    x = rng.standard_normal((2, 256)).astype(np.float32)
    y = tm.process(torch.from_numpy(x)).numpy()
    assert snr_db(np.asarray(jm.process(jnp.asarray(x))), y) >= 110.0


def test_moving_a_channel_resets_the_cascade_it_leaves_in_the_port_and_raises_in_jax(rng):
    """``assign`` in the JAX package drops the state of the channel's new
    cascade only.  The cascade the channel leaves keeps a state with the
    old channel count, and its next ``process`` fails on the shapes.  The
    port starts both cascades from silence."""
    jm, tm = managers()
    x = rng.standard_normal((4, 256)).astype(np.float32)
    jm.process(jnp.asarray(x))
    tm.process(torch.from_numpy(x))
    jm.assign(1, "music")
    tm.assign(1, "music")
    with pytest.raises((ValueError, TypeError)):
        jm.process(jnp.asarray(x))
    y = tm.process(torch.from_numpy(x)).numpy()
    voice = np.stack([golden.biquad_coeffs(FilterType.HPF12, 120.0, FS),
                      golden.biquad_coeffs(FilterType.PEQ, 3000.0, FS,
                                           gain=4.0)])
    music = np.stack([golden.biquad_coeffs(FilterType.LSH, 200.0, FS,
                                           gain=3.0)])
    assert snr_db(golden.cascade_process(x[0], voice)[0], y[0]) > 90.0
    for c in (1, 2):
        assert snr_db(golden.cascade_process(x[c], music)[0], y[c]) > 90.0
