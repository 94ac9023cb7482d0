"""The JAX package's ``dtype`` surface: rings, delay lines, the modal and
parallel IIR engines, K-weighting and the meter, the resampler, the
models and the two-level engine's narrow tail queue, in bfloat16 and
float16, against the JAX package built with the same dtype.

Which leaves the reference stores narrow, and where its arithmetic runs
in the narrow type, follows from JAX's type promotion; the port writes
each of those steps out (``filters/iir.py``).  Three checks, on the same
numpy inputs from a seed:

* every leaf the reference stores narrow is narrow in the port and
  equals JAX's to one step of the narrow type, and every output has the
  reference's dtype;
* run operation by operation (``jax.disable_jit``), the reference's
  narrow arithmetic is the port's, bit for bit, where both take the same
  steps (the engines, the reads, the pipelines);
* against float64, the port's narrow output reads within 1 dB of the
  compiled reference's, either way.  The one deliberate difference:
  XLA:CPU keeps float16 (not bfloat16) values at float32 inside a fused
  computation, so the compiled reference's float16 modal engine reads up
  to 2.2 dB above its own operation-by-operation semantics, which the
  port follows (``test_compiled_float16_reads_above_its_own_semantics``).

The narrow two-level engine's ``process_block`` is held against JAX's
over a stream with both exchange forms, JAX-started narrow streams
continue in the port through ``utils/interop.py`` and through state
files both ways, and the reference faults found on the way are pinned
as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.buffers import delay as jdelay
from bbcat_dsp_tpu.buffers import ring as jring
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_tpu.filters import fractional as jfrac
from bbcat_dsp_tpu.filters import iir as jiir
from bbcat_dsp_tpu.filters.resample import Resampler as JaxResampler
from bbcat_dsp_tpu.formats.sample_format import SampleFormat
from bbcat_dsp_tpu.loudness import itu1770 as jloud
from bbcat_dsp_torch import NonUniformConvolver
from bbcat_dsp_torch.buffers import delay as tdelay
from bbcat_dsp_torch.buffers import ring as tring
from bbcat_dsp_torch.filters import fractional as tfrac
from bbcat_dsp_torch.filters import iir as tiir
from bbcat_dsp_torch.filters.resample import Resampler
from bbcat_dsp_torch.loudness import itu1770 as tloud
from bbcat_dsp_torch.models import binaural as tbinaural
from bbcat_dsp_torch.models import pipeline as tpipeline
from bbcat_dsp_torch.utils.precision import sum_in_order
from conftest import snr_db
from test_torch_iir import one_torch_thread  # noqa: F401

FS = 48000.0
NARROW = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]
IDS = ["bfloat16", "float16"]


# ---- helpers ---------------------------------------------------------------------

def _f64(a) -> np.ndarray:
    """A tensor or (narrow) array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _same_dtype(j, t) -> bool:
    return _dtype_name(j) == _dtype_name(t)


def _within_one_step(j, t) -> None:
    """Two narrow leaves of one dtype agree to one step of it (one unit in
    the last place of the larger magnitude)."""
    assert _same_dtype(j, t), (j.dtype, t.dtype)
    a, b = _f64(j), _f64(t)
    step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
        np.float16 if _dtype_name(t) == "float16" else np.float32))
    if _dtype_name(t) == "bfloat16":
        step = step.astype(np.float64) * 2.0 ** 16
    assert np.all(np.abs(a - b) <= np.maximum(step, 0.0) + 1e-45)


def _leaves_agree(jtree, ttree) -> None:
    """Every leaf of the JAX state has the port's dtype; narrow leaves
    agree to one step, float32 ones to 1e-5 of the leaf's scale."""
    jl = jax.tree.leaves(jtree)
    tl = [t for t in jax.tree.leaves(ttree)
          if isinstance(t, torch.Tensor) and t.is_floating_point()]
    jl = [a for a in jl if np.asarray(a).dtype.kind == "f"
          or _dtype_name(a) == "bfloat16"]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert _same_dtype(j, t), (j.dtype, t.dtype)
        if t.dtype in (torch.bfloat16, torch.float16):
            _within_one_step(j, t)
        else:
            a, b = _f64(j), _f64(t)
            assert np.max(np.abs(a - b)) <= 1e-5 * max(1.0, np.abs(a).max())


def _bits_equal(j, t) -> None:
    np.testing.assert_array_equal(_f64(j), _f64(t))


def _snr_gap(ref, yj, yt) -> tuple:
    """(JAX's SNR against ``ref``, the port's, the gap)."""
    a, b = snr_db(ref, _f64(yj)), snr_db(ref, _f64(yt))
    return a, b, b - a


# Where the compiled reference keeps narrow values wider than their types
# (XLA:CPU: a narrow product summed by jnp.sum is not rounded; float16
# chains stay at float32 inside a fusion), its output departs from its own
# operation-by-operation semantics, which the port follows, by up to
# COMPILED_GAIN_DB against float64 (mostly above it).  The deliberate
# difference, measured in
# test_compiled_reference_keeps_narrow_values_wider_than_their_types.
COMPILED_WIDER = {("fractional_read", "bfloat16"),
                  ("modal_apply", "float16"),
                  ("parallel_cascade_apply", "float16"),
                  ("EQDelayPipeline", "float16"),        # the engines
                  ("BinauralRenderer", "float16")}
COMPILED_GAIN_DB = 3.0


def _assert_gap(path: str, jdt, ref, yj, yt) -> None:
    """The port's SNR against ``ref`` within 1 dB of the compiled
    reference's, either way; within COMPILED_GAIN_DB where the compiler
    keeps float16 or a fused narrow sum wider."""
    _, _, gap = _snr_gap(ref, yj, yt)
    wider = (path, jdt.__name__) in COMPILED_WIDER
    assert abs(gap) <= (COMPILED_GAIN_DB if wider else 1.0), (path, gap)


def _spec(n):
    return resolve_spectral_spec(n, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def eq_stages(n: int) -> np.ndarray:
    return np.stack([golden.biquad_coeffs(golden.FilterType.PEQ,
                                          100.0 * (i + 1), FS,
                                          gain=3.0 * (-1) ** i)
                     for i in range(n)])


def _lfilter_cascade(x, coeffs):
    y = np.asarray(x, np.float64)
    for b0, b1, b2, a1, a2 in np.atleast_2d(coeffs):
        y = lfilter([b0, b1, b2], [1.0, a1, a2], y, axis=-1)
    return y


# ---- the shared check ----------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda d: tring.ring_init((2,), 16, d, device="cpu"),
    lambda d: tdelay.SoundDelayBuffer(2, 16, d, device="cpu"),
    lambda d: tdelay.SoundRingBuffer(2, 16, d, device="cpu"),
    lambda d: tfrac.FractionalDelayLine(2, 64, d, device="cpu"),
    lambda d: Resampler(2, 1.5, 32, d, device="cpu"),
    lambda d: tloud.LoudnessMeter(2, FS, dtype=d, device="cpu"),
    lambda d: tpipeline.EQDelayPipeline(eq_stages(2), 2, 64, 20.0, FS, d,
                                        device="cpu"),
    lambda d: tpipeline.MixdownPipeline(np.ones((1, 2)), dtype=d,
                                        device="cpu"),
    lambda d: tbinaural.BinauralRenderer(np.ones((2, 2, 8)), 16, dtype=d,
                                         device="cpu"),
    lambda d: NonUniformConvolver(np.ones((2, 40)), 4, 2, dtype=d,
                                  device="cpu"),
], ids=["ring_init", "SoundDelayBuffer", "SoundRingBuffer",
        "FractionalDelayLine", "Resampler", "LoudnessMeter",
        "EQDelayPipeline", "MixdownPipeline", "BinauralRenderer",
        "NonUniformConvolver"])
@pytest.mark.parametrize("bad", [torch.float64, torch.int32, np.float32,
                                 "bfloat16"])
def test_every_dtype_argument_refuses_other_types_by_name(make, bad):
    """One check (``utils.precision.storage_dtype``) for every ``dtype``:
    float64 is refused where the port does not compute in it (the JAX
    package quietly makes float32 of it), and the message names the
    accepted set."""
    with pytest.raises(ValueError, match="takes one of"):
        make(bad)
    make(torch.bfloat16)
    make(torch.float16)


@pytest.mark.parametrize("bad", [torch.int32, torch.complex64, "float16"])
def test_the_filter_engines_take_float64_and_refuse_the_rest(bad):
    """The deliberate difference that stays: the modal and parallel
    engines compute in true float64 here (the card has it), where the
    reference's float64 request is quietly float32."""
    c = eq_stages(2)
    assert tiir.modal_params(c[0], device="cpu",
                             dtype=torch.float64).b0.dtype == torch.float64
    assert tiir.parallel_cascade_params(
        c, torch.float64, device="cpu").pr.dtype == torch.float64
    assert jiir.modal_params(c[0], jnp.float64).b0.dtype == jnp.float32
    with pytest.raises(ValueError, match="takes one of"):
        tiir.modal_params(c[0], device="cpu", dtype=bad)
    with pytest.raises(ValueError, match="takes one of"):
        tiir.parallel_cascade_params(c, bad, device="cpu")


# ---- rings and delay lines -----------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_ring_rounds_what_it_is_written(rng, tdt, jdt):
    jr = jring.ring_init((3,), 40, jdt)
    tr = tring.ring_init((3,), 40, tdt, device="cpu")
    assert _same_dtype(jr.data, tr.data)
    for n in (17, 30, 25, 40):
        blk = rng.standard_normal((3, n)).astype(np.float32)
        jr = jring.ring_write(jr, jnp.asarray(blk))
        tr = tring.ring_write(tr, torch.from_numpy(blk))
        _bits_equal(jr.data, tr.data)
        assert int(jr.writepos) == tr.writepos
    got = tring.ring_read_delayed(tr, 7, 5)
    assert got.dtype == tdt
    _bits_equal(jring.ring_read_delayed(jr, 7, 5), got)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_narrow_delay_and_ring_buffers_match_jax_packed_ints_included(
        rng, tdt, jdt):
    """Packed INT24 round trips of a narrow buffer: written through the
    host edge into the narrow ring, read back widened to float32 and
    packed, byte for byte as JAX's."""
    C, L = 3, 64
    for cls_j, cls_t in ((jdelay.SoundDelayBuffer, tdelay.SoundDelayBuffer),
                         (jdelay.SoundRingBuffer, tdelay.SoundRingBuffer)):
        jb, tb = cls_j(C, L, jdt), cls_t(C, L, tdt, device="cpu")
        for _ in range(3):
            x = rng.standard_normal((C, 20)).astype(np.float32) * 0.5
            jb.write(jnp.asarray(x))
            tb.write(torch.from_numpy(x))
        _bits_equal(jb.ring.data, tb.ring.data)
        assert tb.ring.data.dtype == tdt
        raw = rng.integers(0, 256, 11 * C * 3, dtype=np.uint8)
        jb.write_packed(raw, SampleFormat.INT24, False, 0, C, 11)
        tb.write_packed(raw, tdelay.SampleFormat.INT24, False, 0, C, 11)
        _bits_equal(jb.ring.data, tb.ring.data)
        if cls_t is tdelay.SoundDelayBuffer:
            got = tb.read(30, 12)
            assert got.dtype == tdt
            _bits_equal(jb.read(30, 12), got)
            np.testing.assert_array_equal(
                jb.read_packed(SampleFormat.INT24, True, 30, 12),
                tb.read_packed(tdelay.SampleFormat.INT24, True, 30, 12))
            jb.set_size(100)
            tb.set_size(100)
            assert tb.ring.data.dtype == tdt
            _bits_equal(jb.ring.data, tb.ring.data)
        else:
            got = tb.read(25)
            assert got.dtype == tdt
            _bits_equal(jb.read(25), got)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("stream", [False, True], ids=["gather", "stream"])
def test_fractional_reads_of_a_narrow_buffer(rng, tdt, jdt, stream):
    """The table rounded to the buffer's type and the output in it;
    operation by operation the reference's reads are the port's, bit for
    bit, and against the float64 read of the float32 buffer the two read
    within 1 dB (the compiled gather read: ``COMPILED_WIDER``)."""
    C, L, n = 3, 256, 100
    buf = rng.standard_normal((C, L)).astype(np.float32)
    start = rng.uniform(20.0, 200.0, C).astype(np.float32)
    pos = (start[:, None] + np.arange(n, dtype=np.float32)) % L
    jb, tb = jnp.asarray(buf).astype(jdt), torch.from_numpy(buf).to(tdt)
    if stream:
        def jcall():
            return jfrac.fractional_read_stream(jb, jnp.asarray(start), n)
        got = tfrac.fractional_read_stream(tb, torch.from_numpy(start), n)
    else:
        def jcall():
            return jfrac.fractional_read(jb, jnp.asarray(pos))
        got = tfrac.fractional_read(tb, torch.from_numpy(pos))
    assert got.dtype == tdt
    with jax.disable_jit():
        _bits_equal(jcall(), got)
    ref = tfrac.fractional_read(torch.from_numpy(buf.astype(np.float64)),
                                torch.from_numpy(pos)).numpy()
    _assert_gap(f"fractional_read{'_stream' * stream}", jdt, ref, jcall(),
                got)



# ---- the order of a float32 accumulation -------------------------------------
#
# The reference's operation-by-operation semantics fix each rounding but
# one: the order in which a float32 dot or sum accumulates.  XLA:CPU's
# eager dot fuses each multiply-add in index order, and its eager sum of a
# narrow operand adds the widened terms in index order.  The port follows
# both orders; on a host where its broadcast matrix product (ATen's own
# loop, no FMA) or ``torch.sum``'s partial sums took another, a float16
# pipeline's ring and reads departed from JAX's by one step at a few
# samples.

def _fma_in_order(a: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``a [K, R, L] @ m [K, L, N]`` as fused multiply-adds in index order
    from zero, in float32: a product of a float32 and a narrow value is
    exact in float64, and each step's sum rounds once to float32."""
    s = np.zeros(a.shape[:-1] + m.shape[-1:], np.float32)
    for k in range(a.shape[-1]):
        s = (s + a[..., k, None].astype(np.float64)
             * m[:, None, k, :]).astype(np.float32)
    return s


def _add_in_order(terms: np.ndarray, axis: int) -> np.ndarray:
    """The float32 sum of ``terms`` along ``axis``, one term after the
    other in index order."""
    terms = np.moveaxis(terms.astype(np.float32), axis, 0)
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s


@pytest.mark.parametrize("cd", ["float32", "bfloat16", "float16"])
def test_the_toeplitz_product_fuses_each_multiply_add_in_index_order(rng, cd):
    """The modal engine's chunk product (``_cpx_affine_scan_const``'s
    ``einsum`` at HIGHEST, run eagerly) is the in-order FMA model bit for
    bit, and so is the port's ``_narrow_bmm``.  Against a float32 signal
    an order that rounds each product reads other bits on these inputs;
    a product of two narrow values is exact in float32, so there the two
    orders meet and only the order of the sum counts."""
    K, Bb, n, L = 2, 3, 2, 128
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    wide = rng.standard_normal((K, Bb, n, L)) * np.exp2(
        rng.integers(-8, 4, (K, Bb, n, L)))
    pw = rng.uniform(-1.0, 1.0, (K, L, L)) * np.exp2(
        rng.integers(-10, 1, (K, L, L)))
    a = np.array(jnp.asarray(wide, jdt).astype(jnp.float32))
    # the powers narrow; against a float32 signal, widened (the models')
    m_dt = jnp.float16 if cd == "float32" else jdt
    m = np.triu(np.asarray(jnp.asarray(pw, m_dt).astype(jnp.float32)))
    fused = _fma_in_order(a.reshape(K, Bb * n, L), m).reshape(a.shape)
    rounded = _add_in_order(a[..., :, None] * m[:, None, None], -2)
    assert np.any(fused != rounded) == (cd == "float32")
    want = np.asarray(jnp.asarray(fused).astype(jdt).astype(jnp.float32))
    with jax.disable_jit():
        ref = jnp.einsum("kbnl,klm->kbnm", jnp.asarray(a, jdt),
                         jnp.asarray(m, jdt),
                         precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(_f64(ref), want)
    got = tiir._narrow_bmm(torch.from_numpy(a).to(tdt),
                           torch.from_numpy(m).to(tdt), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f64(got), want)


@pytest.mark.parametrize("axis,terms", [(-1, 14), (0, 6), (0, 16)],
                         ids=["taps", "poles", "eight-stages"])
@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_sum_adds_in_index_order(rng, tdt, jdt, axis, terms):
    """``jnp.sum`` of a narrow operand, run eagerly, is the float32 sum in
    index order rounded once (the 14 taps of a fractional read, the poles
    of a parallel cascade); so is the port's ``sum_in_order``."""
    shape = [4096, 3]
    shape.insert(0 if axis == 0 else 2, terms)
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-12, 4, shape))
    p = jnp.asarray(v, jdt)
    want = np.asarray(jnp.asarray(_add_in_order(
        np.asarray(p.astype(jnp.float32)), axis)).astype(jdt)
        .astype(jnp.float32))
    with jax.disable_jit():
        np.testing.assert_array_equal(_f64(jnp.sum(p, axis=axis)), want)
    got = sum_in_order(torch.from_numpy(np.asarray(p.astype(jnp.float32)))
                       .to(tdt), axis).to(tdt)
    np.testing.assert_array_equal(_f64(got), want)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_gather_read_is_the_references_at_every_position(rng, tdt,
                                                                  jdt):
    """The gather read over a ring whose samples span 16 octaves, at 24576
    random positions: bit for bit against the reference run operation by
    operation, where a sum in another order misses a few."""
    C, L, n = 4, 512, 6144
    buf = (rng.standard_normal((C, L))
           * np.exp2(rng.integers(-12, 4, (C, L)))).astype(np.float32)
    pos = rng.uniform(0.0, L, (C, n)).astype(np.float32)
    got = tfrac.fractional_read(torch.from_numpy(buf).to(tdt),
                                torch.from_numpy(pos))
    with jax.disable_jit():
        _bits_equal(jfrac.fractional_read(jnp.asarray(buf).astype(jdt),
                                          jnp.asarray(pos)), got)

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_fractional_delay_line_streams_as_jax(rng, tdt, jdt):
    C, L = 2, 128
    jl = jfrac.FractionalDelayLine(C, L, jdt)
    tl = tfrac.FractionalDelayLine(C, L, tdt, device="cpu")
    for i in range(6):
        x = rng.standard_normal((C, 48)).astype(np.float32)
        jl.write(jnp.asarray(x))
        tl.write(torch.from_numpy(x))
        _bits_equal(jl.buf, tl.buf)
        d = rng.uniform(1.0, 60.0, (C, 8)).astype(np.float32)
        got = tl.read(d)
        assert got.dtype == tdt
        with jax.disable_jit():
            _bits_equal(jl.read(jnp.asarray(d)), got)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_resampler_keeps_the_references_dtype_flow(rng, tdt, jdt):
    """The history starts narrow (silence) and is float32 after a block,
    as the reference's: its output is the float32 resampler's, exactly,
    in both packages."""
    C, B = 2, 64
    jr = JaxResampler(C, 1.37, B, jdt)
    tr = Resampler(C, 1.37, B, tdt, device="cpu")
    twin = Resampler(C, 1.37, B, device="cpu")
    assert _same_dtype(jr.hist, tr.hist) and tr.hist.dtype == tdt
    for i in range(5):
        x = rng.standard_normal((C, B)).astype(np.float32)
        yj = jr.process(jnp.asarray(x))
        yt = tr.process(torch.from_numpy(x))
        assert yt.dtype == torch.float32 and _same_dtype(yj, yt)
        assert torch.equal(yt, twin.process(torch.from_numpy(x)))
        assert snr_db(_f64(yj), _f64(yt)) >= 110.0
        assert _same_dtype(jr.hist, tr.hist)


# ---- the IIR engines ---------------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_narrow_modal_and_parallel_params_are_rounded_once(tdt, jdt):
    c = eq_stages(3)
    _leaves_agree(jiir.modal_params(c, jdt),
                  tiir.modal_params(c, device="cpu", dtype=tdt))
    _leaves_agree(jiir.parallel_cascade_params(c, jdt),
                  tiir.parallel_cascade_params(c, tdt, device="cpu"))
    p = tiir.modal_params(c, device="cpu", dtype=tdt)
    jp = jiir.modal_params(c, jdt)
    for d in (None, tdt, torch.float32):
        jd = jnp.float32 if d is None else getattr(jnp, _dtype_name_of(d))
        _leaves_agree(jiir.modal_init(jp, (2, 3), jd),
                      tiir.modal_init(p, (2, 3), d))


def _dtype_name_of(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("T", [512, 300], ids=["toeplitz", "scan"])
@pytest.mark.parametrize("narrow_x", [False, True],
                         ids=["float32-signal", "narrow-signal"])
def test_the_narrow_modal_engine_is_the_references(rng, tdt, jdt, T,
                                                   narrow_x):
    """Narrow parameters against a float32 signal (the models' case: the
    output and state float32, the pole powers and the maps' poles narrow)
    and a narrow signal (the input's type everywhere), on both branches,
    streamed over two calls."""
    c = eq_stages(2)[1]
    jp, tp = jiir.modal_params(c, jdt), tiir.modal_params(c, device="cpu",
                                                          dtype=tdt)
    x = rng.standard_normal((3, 2 * T)).astype(np.float32)
    js = jo = ts = None
    outs = []
    for k in range(2):
        piece = x[:, k * T:(k + 1) * T]
        xj = jnp.asarray(piece).astype(jdt if narrow_x else jnp.float32)
        xt = torch.from_numpy(piece).to(tdt if narrow_x else torch.float32)
        with jax.disable_jit():
            yo, jo = jiir.modal_apply(xj, jp, jo)
        yj, js = jiir.modal_apply(xj, jp, js)
        yt, ts = tiir.modal_apply(xt, tp, ts)
        assert _same_dtype(yj, yt)
        assert yt.dtype == (tdt if narrow_x else torch.float32)
        if narrow_x:
            _bits_equal(yo, yt)
        else:       # float32 sums in another order
            assert snr_db(_f64(yo), _f64(yt)) >= 130.0
        _leaves_agree(jo, ts)
        assert all(_same_dtype(a, b) for a, b in zip(js, ts))
        outs.append((yj, yt))
    yj = np.concatenate([_f64(a) for a, _ in outs], -1)
    yt = np.concatenate([_f64(b) for _, b in outs], -1)
    _assert_gap("modal_apply", jdt, _lfilter_cascade(x, c), yj, yt)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("T", [512, 300], ids=["toeplitz", "scan"])
@pytest.mark.parametrize("narrow_x", [False, True],
                         ids=["float32-signal", "narrow-signal"])
def test_the_narrow_parallel_cascade_is_the_references(rng, tdt, jdt, T,
                                                       narrow_x):
    c = eq_stages(3)
    jp = jiir.parallel_cascade_params(c, jdt)
    tp = tiir.parallel_cascade_params(c, tdt, device="cpu")
    x = rng.standard_normal((2, T)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt if narrow_x else jnp.float32)
    xt = torch.from_numpy(x).to(tdt if narrow_x else torch.float32)
    with jax.disable_jit():
        yo, _ = jiir.parallel_cascade_apply(xj, jp)
    yj, js = jiir.parallel_cascade_apply(xj, jp)
    yt, ts = tiir.parallel_cascade_apply(xt, tp)
    assert _same_dtype(yj, yt) and _same_dtype(js.sr, ts.sr)
    assert snr_db(_f64(yo), _f64(yt)) >= (200.0 if narrow_x else 130.0)
    _assert_gap("parallel_cascade_apply", jdt, _lfilter_cascade(x, c), yj,
                yt)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_the_engines_take_their_type_from_a_narrow_signal(rng, tdt, jdt):
    """``biquad_apply`` factors host coefficients in the signal's type,
    ``cascade_apply(engine="parallel")`` likewise (the reference's
    ``iir.py:258``, ``:864-869``, ``:903``)."""
    c = eq_stages(3)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    with jax.disable_jit():
        yj, sj = jiir.biquad_apply(xj, c[0])
        zj, _ = jiir.cascade_apply(xj, c, engine="parallel")
    yt, st = tiir.biquad_apply(xt, c[0])
    zt, _ = tiir.cascade_apply(xt, c, engine="parallel")
    assert yt.dtype == tdt == zt.dtype == st.tr.dtype
    _bits_equal(yj, yt)
    _leaves_agree(sj, st)
    assert snr_db(_f64(zj), _f64(zt)) >= 200.0


# ---- K-weighting and the meter ------------------------------------------------

FS_METER = 12000.0     # a 100 ms step of 1200 samples: the doubling scan


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_k_weighting_of_a_narrow_signal(rng, tdt, jdt):
    """The filters designed in the signal's type, the output in it; the
    gating powers in float32 from the narrow squares."""
    x = (rng.standard_normal((2, 6000)) * 0.2).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    _leaves_agree(jloud.k_weight_params(FS_METER, jdt),
                  tloud.k_weight_params(FS_METER, tdt, device="cpu"))
    with jax.disable_jit():
        yj, sj = jloud.k_weight(xj, FS_METER)
        zj, _ = jloud.block_powers(xj, FS_METER)
    yt, st = tloud.k_weight(xt, FS_METER)
    zt, _ = tloud.block_powers(xt, FS_METER)
    assert yt.dtype == tdt and zt.dtype == torch.float32
    _bits_equal(yj, yt)
    _leaves_agree(sj, st)
    assert snr_db(_f64(zj), _f64(zt)) >= 120.0


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_narrow_meter_matches_jax(rng, tdt, jdt):
    """The parameters, weights, filter states and squared tail narrow, the
    filter states float32 after a block, the tail rounded back each block;
    the readouts agree with JAX's and the integrated loudness with a
    float64 gating."""
    C, step = 3, int(0.1 * FS_METER)
    x = (rng.standard_normal((C, 12 * step)) * 0.1
         * np.array([[1.0], [0.5], [0.25]])).astype(np.float32)
    jm = jloud.LoudnessMeter(C, FS_METER, dtype=jdt)
    jo = jloud.LoudnessMeter(C, FS_METER, dtype=jdt)
    tm = tloud.LoudnessMeter(C, FS_METER, dtype=tdt, device="cpu")
    _leaves_agree(jm.state, tm.state)
    _leaves_agree(jm.weights, tm.weights)
    for k in range(0, 12, 2):
        piece = x[:, k * step:(k + 2) * step]
        jm.process(jnp.asarray(piece))
        with jax.disable_jit():
            jo.process(jnp.asarray(piece))
        tm.process(torch.from_numpy(piece))
        assert [_dtype_name(a) for a in jax.tree.leaves(jm.state)
                if a.ndim] == [_dtype_name(t) for t in jax.tree.leaves(
                    tm.state) if isinstance(t, torch.Tensor) and t.ndim]
        _within_one_step(jo.state.sq_tail, tm.state.sq_tail)
    want = golden.integrated_loudness(x.astype(np.float64), FS_METER,
                                      tloud.default_channel_weights(C))
    for meter in (jm, jo):
        assert abs(meter.integrated() - tm.integrated()) <= 0.01
        assert abs(meter.momentary() - tm.momentary()) <= 0.01
    assert abs(tm.integrated() - want) <= 0.05


# ---- the deliberate difference -------------------------------------------------

@pytest.mark.parametrize("path", ["modal_apply float16",
                                  "parallel_cascade_apply float16",
                                  "fractional_read bfloat16"])
def test_compiled_reference_keeps_narrow_values_wider_than_their_types(
        rng, path):
    """Compiled, the reference computes some narrow steps wider than its
    types say: XLA:CPU sums a bfloat16 product inside ``jnp.sum`` without
    rounding it, and keeps float16 chains at float32 inside a fusion.  Its
    compiled output then differs from its own operation-by-operation
    output, which the port equals, and reads within COMPILED_GAIN_DB of
    it against float64, mostly above (measured -2.5 to +0.9 dB, the port
    against the compiled reference).  bfloat16 modal arithmetic is rounded
    as its types say, compiled or not (the test below)."""
    name, dt = path.split()
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    c = eq_stages(3)
    if name == "fractional_read":
        pos = (rng.uniform(20.0, 200.0, 3)[:, None].astype(np.float32)
               + np.arange(100, dtype=np.float32)) % 512

        def jcall():
            return jfrac.fractional_read(jnp.asarray(x).astype(jdt),
                                         jnp.asarray(pos))
        got = tfrac.fractional_read(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(pos))
        ref = tfrac.fractional_read(torch.from_numpy(x.astype(np.float64)),
                                    torch.from_numpy(pos)).numpy()
    elif name == "modal_apply":
        def jcall():
            return jiir.modal_apply(jnp.asarray(x),
                                    jiir.modal_params(c[1], jdt))[0]
        got = tiir.modal_apply(torch.from_numpy(x), tiir.modal_params(
            c[1], device="cpu", dtype=tdt))[0]
        ref = _lfilter_cascade(x, c[1])
    else:
        def jcall():
            return jiir.parallel_cascade_apply(
                jnp.asarray(x), jiir.parallel_cascade_params(c, jdt))[0]
        got = tiir.parallel_cascade_apply(torch.from_numpy(x),
                                          tiir.parallel_cascade_params(
                                              c, tdt, device="cpu"))[0]
        ref = _lfilter_cascade(x, c)
    compiled = jcall()
    with jax.disable_jit():
        op_by_op = jcall()
    assert snr_db(_f64(op_by_op), _f64(got)) >= 130.0
    assert not np.array_equal(_f64(compiled), _f64(op_by_op))
    _, _, gap = _snr_gap(ref, compiled, got)
    assert abs(gap) <= COMPILED_GAIN_DB


def test_bfloat16_modal_arithmetic_compiles_as_its_types_say(rng):
    x = rng.standard_normal((3, 512)).astype(np.float32)
    p = jiir.modal_params(eq_stages(2)[1], jnp.bfloat16)
    compiled = jiir.modal_apply(jnp.asarray(x).astype(jnp.bfloat16), p)[0]
    with jax.disable_jit():
        op_by_op = jiir.modal_apply(jnp.asarray(x).astype(jnp.bfloat16), p)[0]
    _bits_equal(compiled, op_by_op)
