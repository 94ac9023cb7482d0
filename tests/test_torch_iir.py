"""The port's biquad design and modal IIR engine against the JAX package.

Design is float64 on the host in both packages, so the coefficients agree
to 1e-12.  ``modal_apply`` runs the same numpy inputs through both engines
on the CPU, streamed over three calls, at block lengths that take each of
its branches (T = 4800: the general scan; T = 512, 9600 and 20480: the
Toeplitz products, the last with its chunk carries scanned).  Output is held at >= 110 dB against JAX, the state's input
history exactly, and the two complex pole states ``t = tr + i ti`` and
``w = wr + i wi`` at >= 110 dB as complex pairs: for a conjugate pole pair
``wi`` is zero in exact arithmetic, so alone it is rounding noise in both
packages and has no SNR of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.filters import biquad as jbiquad
from bbcat_dsp_tpu.filters import iir as jiir
from bbcat_dsp_torch.filters import (
    FilterType,
    biquad_coeffs,
    biquad_response,
    cascade_response,
    design_bank,
    iir,
    modal_apply,
    modal_init,
    modal_params,
)
from bbcat_dsp_torch.utils.interop import modal_from_jax, to_numpy
from conftest import snr_db

FS = 48000.0
PEQ = golden.biquad_coeffs(FilterType.PEQ, 1000.0, FS, gain=6.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once, and a pool of threads per process oversubscribes
    the cores (a 100x slowdown of the long loudness signals)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def complex_snr_db(ref_re, ref_im, re, im) -> float:
    ref = np.asarray(ref_re, np.float64) + 1j * np.asarray(ref_im, np.float64)
    got = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    noise = np.sum(np.abs(ref - got) ** 2)
    return np.inf if noise == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2) / noise)


def assert_modal_states_agree(js, ts, check_poles: bool = True):
    """``js`` the JAX ModalState, ``ts`` the port's, at >= 110 dB; every
    port leaf contiguous.  ``check_poles=False`` leaves the two pole states
    to the caller."""
    assert all(t.is_contiguous() for t in ts)
    for name in ("x1", "x2"):
        assert snr_db(np.asarray(getattr(js, name)),
                      getattr(ts, name).numpy()) >= 110.0, name
    if check_poles:
        assert complex_snr_db(js.tr, js.ti, ts.tr, ts.ti) >= 110.0
        assert complex_snr_db(js.wr, js.wi, ts.wr, ts.wi) >= 110.0


@pytest.mark.parametrize("ftype", list(FilterType))
def test_biquad_coeffs_match_golden(ftype):
    c = biquad_coeffs(ftype, 1234.0, FS, gain=5.5, bandwidth=0.7)
    want = golden.biquad_coeffs(ftype, 1234.0, FS, gain=5.5, bandwidth=0.7)
    assert c.dtype == np.float64
    np.testing.assert_allclose(c, want, rtol=0, atol=1e-12)
    assert int(ftype) == int(golden.FilterType[ftype.name])


def test_responses_and_bank_match_jax():
    specs = [(FilterType.LPF12, 8000.0, FS), (FilterType.PEQ, 500.0, FS, -3.0),
             {"type": "HSH", "freq": 3000.0, "fs": FS, "gain": 2.0}]
    jspecs = [(jbiquad.FilterType(int(s[0])),) + s[1:] if isinstance(s, tuple)
              else s for s in specs]
    bank = design_bank(specs)
    np.testing.assert_allclose(bank, jbiquad.design_bank(jspecs), rtol=0,
                               atol=1e-12)
    f = np.geomspace(10.0, 20000.0, 64)
    np.testing.assert_allclose(biquad_response(bank[1], f, FS),
                               jbiquad.biquad_response(bank[1], f, FS),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cascade_response(bank, f, FS),
                               jbiquad.cascade_response(bank, f, FS),
                               rtol=1e-12, atol=1e-12)


def _branch_spy(monkeypatch):
    calls = []
    real = iir._cpx_affine_scan_const

    def spy(*a):
        calls.append(a[2].shape[-1])
        return real(*a)

    monkeypatch.setattr(iir, "_cpx_affine_scan_const", spy)
    return calls


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("T", [4800, 512, 9600, 20480])
def test_modal_apply_matches_jax(rng, monkeypatch, T, C):
    """Three calls of T samples through both engines; the branch taken is
    the JAX package's gate: Toeplitz exactly when T % 128 == 0 and
    T >= 256.  At T = 20480 (160 chunks) the Toeplitz branch scans its
    chunk carries; at 512 and 9600 it takes them in one product."""
    calls = _branch_spy(monkeypatch)
    jp, tp = jiir.modal_params(PEQ), modal_params(PEQ, device="cpu")
    for name, a in zip(tp._fields, tp):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jp, name)))
    x = rng.standard_normal((C, 3 * T)).astype(np.float32)
    js, ts = None, None
    for k in range(3):
        piece = x[:, k * T:(k + 1) * T]
        yj, js = jiir.modal_apply(jnp.asarray(piece), jp, js)
        yt, ts = modal_apply(torch.from_numpy(piece), tp, ts)
        assert yt.shape == (C, T)
        assert snr_db(np.asarray(yj), yt.numpy()) >= 110.0
        assert_modal_states_agree(js, ts)
    toeplitz = T % 128 == 0 and T >= 256
    assert len(calls) == (6 if toeplitz else 0)


def test_modal_batched_poles_match_jax(rng):
    """Per-channel poles ``[C]`` (each channel its own filter): the
    Toeplitz branch batches the poles on its K axis; a leading batch
    before the pole axis stays a batch."""
    rows = np.stack([golden.biquad_coeffs(t, 700.0 + 300 * i, FS, gain=4.0)
                     for i, t in enumerate((FilterType.PEQ, FilterType.LSH,
                                            FilterType.LPF12))])
    jp, tp = jiir.modal_params(rows), modal_params(rows, device="cpu")
    for shape in ((3, 512), (2, 3, 512), (3, 300)):
        x = rng.standard_normal(shape).astype(np.float32)
        yj, js = jiir.modal_apply(jnp.asarray(x), jp)
        yt, ts = modal_apply(torch.from_numpy(x), tp)
        assert snr_db(np.asarray(yj), yt.numpy()) >= 110.0
        assert_modal_states_agree(js, ts)


@pytest.mark.parametrize("ftype", list(FilterType))
def test_modal_all_types_vs_golden(rng, ftype):
    """Every RBJ type >= 90 dB against the float64 DF2T recursion, over a
    stream that crosses between the branches (4800, 512, 9600 samples)."""
    kw = {"gain": 7.5} if ftype in (FilterType.PEQ, FilterType.LSH,
                                    FilterType.HSH) else {}
    c = golden.biquad_coeffs(ftype, 740.0, FS, bandwidth=0.8, **kw)
    x = rng.standard_normal(4800 + 512 + 9600).astype(np.float32)
    ref, _ = golden.biquad_process(x, c)
    p, st, ys, t0 = modal_params(c, device="cpu"), None, [], 0
    for T in (4800, 512, 9600):
        y, st = modal_apply(torch.from_numpy(x[t0:t0 + T]), p, st)
        ys.append(y.numpy())
        t0 += T
    assert snr_db(ref, np.concatenate(ys)) >= 90.0


def test_modal_params_need_f64_coeffs(rng):
    """Poles factored from float32-rounded coefficients lose about 30 dB
    (LSH at 200 Hz): the port, like the JAX package, takes float64."""
    c64 = golden.biquad_coeffs(FilterType.LSH, 200.0, FS, gain=3.0)
    x = rng.standard_normal(4096).astype(np.float32)
    ref, _ = golden.biquad_process(x, c64)
    y64, _ = modal_apply(torch.from_numpy(x), modal_params(c64, device="cpu"))
    y32, _ = modal_apply(torch.from_numpy(x),
                         modal_params(c64.astype(np.float32), device="cpu"))
    assert snr_db(ref, y64.numpy()) > 110.0
    assert snr_db(ref, y64.numpy()) > snr_db(ref, y32.numpy()) + 10.0


def test_modal_init_and_short_blocks(rng):
    p = modal_params(PEQ, device="cpu")
    st = modal_init(p, (4,))
    assert all(a.shape == (4,) and not a.any() for a in st)
    with pytest.raises(ValueError, match="T >= 2"):
        modal_apply(torch.zeros(4, 1), p, st)
    # T = 2 and odd lengths take the general scan
    x = rng.standard_normal((4, 2 + 7)).astype(np.float32)
    jp = jiir.modal_params(PEQ)
    yj, js = jiir.modal_apply(jnp.asarray(x[:, :2]), jp)
    yj2, js = jiir.modal_apply(jnp.asarray(x[:, 2:]), jp, js)
    yt, ts = modal_apply(torch.from_numpy(x[:, :2]), p, st)
    yt2, ts = modal_apply(torch.from_numpy(x[:, 2:]), p, ts)
    assert snr_db(np.concatenate([yj, yj2], -1),
                  torch.cat([yt, yt2], -1).numpy()) >= 110.0


def test_modal_stream_crosses_packages(rng):
    """A stream started in JAX continues in the port, and back."""
    T = 512
    jp, tp = jiir.modal_params(PEQ), modal_params(PEQ, device="cpu")
    x = rng.standard_normal((3, 4 * T)).astype(np.float32)
    yj, js = jiir.modal_apply(jnp.asarray(x[:, :2 * T]), jp)
    ts = modal_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert modal_from_jax(jax.tree.map(np.asarray, jp), device="cpu")._fields \
        == tp._fields
    yt, ts = modal_apply(torch.from_numpy(x[:, 2 * T:3 * T]), tp, ts)
    yj2, js = jiir.modal_apply(jnp.asarray(x[:, 2 * T:3 * T]), jp, js)
    assert snr_db(np.asarray(yj2), yt.numpy()) >= 110.0
    # back: the port's state, as numpy leaves, is a JAX ModalState
    js_back = jiir.ModalState(*map(jnp.asarray, to_numpy(ts)))
    yj3, _ = jiir.modal_apply(jnp.asarray(x[:, 3 * T:]), jp, js_back)
    yj4, _ = jiir.modal_apply(jnp.asarray(x[:, 3 * T:]), jp, js)
    assert snr_db(np.asarray(yj4), np.asarray(yj3)) >= 110.0
