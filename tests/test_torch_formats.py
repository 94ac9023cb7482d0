"""The port's sample formats against the JAX package's, byte for byte.

Host side: the tables, the clamps, pack / unpack, the conversions and the
rectangle transfer for every pair of formats and byte orders, through the
native engine and through numpy in each package, and both ditherers from
the same seed.  Device side: ``quantize`` without dither bit for bit, with
a generator to the dither's contract; ``convert``, ``transfer_window`` and
the (de)interleave.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import formats as jformats
from bbcat_dsp_tpu.formats import device as jdevice
from bbcat_dsp_tpu.formats import host as jhost
from bbcat_dsp_tpu.utils import native as jnative
from bbcat_dsp_torch import formats
from bbcat_dsp_torch.formats import device, host
from bbcat_dsp_torch.formats.sample_format import SampleFormat
from bbcat_dsp_torch.utils import native

F = SampleFormat
FORMATS = [F.INT16, F.INT24, F.INT32, F.FLOAT, F.DOUBLE]
ORDERS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_paths(monkeypatch):
    """Both packages on their numpy paths: no native engine."""
    monkeypatch.setattr(native, "transfer_rect", lambda *a, **k: False)
    monkeypatch.setattr(native, "shaped_dither_block", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "transfer_rect", lambda *a, **k: False)
    monkeypatch.setattr(jnative, "shaped_dither_block", lambda *a, **k: None)


def _packed(rng, fmt, be, n):
    """Valid packed bytes of ``fmt`` (floats within [-2, 2], so both
    saturation edges are crossed)."""
    if fmt in (F.FLOAT, F.DOUBLE):
        v = rng.standard_normal(n) * 0.7
        dt = np.dtype("f4" if fmt == F.FLOAT else "f8")
        return np.frombuffer(v.astype(dt.newbyteorder(">" if be else "<"))
                             .tobytes(), np.uint8).copy()
    if fmt == F.INT24:
        return rng.integers(0, 256, n * 3).astype(np.uint8)
    bits = 16 if fmt == F.INT16 else 32
    v = rng.integers(-2**(bits - 1), 2**(bits - 1), n)
    return np.frombuffer(v.astype((">" if be else "<") + f"i{bits // 8}")
                         .tobytes(), np.uint8).copy()


def test_tables_match_jax():
    for fmt in F:
        assert formats.get_bits_per_sample(fmt) == \
            jformats.get_bits_per_sample(fmt)
        assert formats.get_bytes_per_sample(fmt) == \
            jformats.get_bytes_per_sample(fmt)
        assert formats.is_sample_float(fmt) == jformats.is_sample_float(fmt)
        assert formats.is_sample_integer(fmt) == \
            jformats.is_sample_integer(fmt)
        assert int(fmt) == int(jformats.SampleFormat[fmt.name])
    assert formats.SAMPLE_FORMAT_COUNT == jformats.SAMPLE_FORMAT_COUNT
    for dt in (np.int16, np.int32, np.float32, np.float64, np.uint8,
               np.int8, np.complex64):
        assert formats.sample_format_of(dt) == jformats.sample_format_of(dt)
        assert formats.sample_format_of(np.zeros(2, dt)) == \
            jformats.sample_format_of(np.zeros(2, dt))


@pytest.mark.parametrize("args", [
    (2, 4, 0, 8, 10, 5), (0, 4, 0, 4, 4, 10), (5, 4, 0, 4, 1, 10),
    (0, 4, 3, 4, 4, 10), (1, 3, 2, 4, 8, 7), (0, 2, 0, 2, 2, 0),
    (0, 1, 0, 1, 1, 16),
])
@pytest.mark.parametrize("single", [True, False])
def test_block_transfer_sanity_checks_match_jax(args, single):
    assert formats.block_transfer_sanity_checks(
        *args, allow_single_channel=single) == \
        jformats.block_transfer_sanity_checks(*args,
                                              allow_single_channel=single)


def test_host_float_int_conversions_match_jax(rng):
    x = np.r_[0.0, 1.0, -1.0, 0.5, -0.5, 1.5, -1.5, 2.0**-31, -(2.0**-31),
              1.0 - 2.0**-24, 0.9999999999, -0.9999999999,
              rng.uniform(-1.2, 1.2, 1000)]
    np.testing.assert_array_equal(host.float_to_int32(x),
                                  jhost.float_to_int32(x))
    v = np.r_[np.array([2**31 - 1, -(2**31), 0, 1 << 16], np.int32),
              rng.integers(-2**31, 2**31, 1000).astype(np.int32)]
    for double in (False, True):
        a = host.int32_to_float(v, double=double)
        b = jhost.int32_to_float(v, double=double)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("be", [False, True])
def test_pack_unpack_match_jax(rng, fmt, be):
    raw = _packed(rng, fmt, be, 64)
    vals = host.unpack(raw, fmt, be)
    want = jhost.unpack(raw, fmt, be)
    assert vals.dtype == want.dtype
    np.testing.assert_array_equal(vals, want)
    packed = host.pack(vals, fmt, be)
    np.testing.assert_array_equal(packed, jhost.pack(want, fmt, be))
    np.testing.assert_array_equal(packed, raw)


@pytest.mark.parametrize("sfmt,dfmt", list(itertools.product(FORMATS,
                                                             FORMATS)))
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_transfer_samples_matches_jax_for_every_pair(rng, request, sfmt,
                                                     dfmt, path):
    """A rectangle of 2 channels from channel 1 of 3 into channel 2 of 4,
    every byte order, on the same path in both packages."""
    if path == "numpy":
        request.getfixturevalue("numpy_paths")
    else:
        assert native.native_available() and jnative.native_available()
    for sbe, dbe in ORDERS:
        nfr, sch, dch, nch = 17, 3, 4, 2
        raw = _packed(rng, sfmt, sbe, nfr * sch)
        ours = np.full(nfr * dch * formats.get_bytes_per_sample(dfmt), 0x5A,
                       np.uint8)
        theirs = ours.copy()
        assert host.transfer_samples(raw, sfmt, sbe, 1, sch, ours, dfmt, dbe,
                                     2, dch, nch, nfr)
        assert jhost.transfer_samples(raw, sfmt, sbe, 1, sch, theirs, dfmt,
                                      dbe, 2, dch, nch, nfr)
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("sfmt,dfmt", [(F.FLOAT, F.INT24), (F.INT32, F.INT16),
                                       (F.DOUBLE, F.FLOAT), (F.INT24, F.INT24),
                                       (F.INT16, F.DOUBLE)])
def test_native_engine_matches_the_numpy_path(rng, sfmt, dfmt):
    """Within the port: the C++ engine and numpy write the same bytes,
    the whole-frame collapse included."""
    assert native.status()["available"]
    for sbe, dbe in ORDERS:
        nfr, nch = 33, 5
        raw = _packed(rng, sfmt, sbe, nfr * nch)
        a = np.zeros(nfr * nch * formats.get_bytes_per_sample(dfmt), np.uint8)
        b = a.copy()
        assert native.transfer_rect_path(raw, sfmt, sbe, 0, nch, a, dfmt,
                                         dbe, 0, nch, nch * nfr, 1) >= 0
        orig = native.transfer_rect
        native.transfer_rect = lambda *args, **kw: False
        try:
            host.transfer_samples(raw, sfmt, sbe, 0, nch, b, dfmt, dbe, 0,
                                  nch, nch, nfr)
        finally:
            native.transfer_rect = orig
        np.testing.assert_array_equal(a, b)


def test_native_engine_builds_once_and_reports_it():
    st = native.status()
    assert st["available"] and st["error"] is None
    assert "_build" in st["path"] and st["path"].endswith(".so")
    assert native.get_lib().fc_version() == 2
    assert native.status() == st                    # built once a process


@pytest.mark.parametrize("dfmt", [F.INT16, F.INT24])
def test_tpdf_dither_matches_jax_with_the_same_seed(rng, dfmt):
    x = (rng.standard_normal((400, 3)) * 1e-3).astype(np.float32)
    src = x.reshape(-1).view(np.uint8)
    outs = []
    for mod, ditherer in ((host, formats.TPDFDitherer(seed=7)),
                          (jhost, jformats.TPDFDitherer(seed=7))):
        out = np.zeros(x.size * formats.get_bytes_per_sample(dfmt), np.uint8)
        mod.transfer_samples(src, F.FLOAT, False, 0, 3, out, dfmt, False, 0,
                             3, 3, 400, ditherer=ditherer)
        outs.append(out)
    np.testing.assert_array_equal(*outs)
    assert formats.TPDFDitherer(seed=3).dither(0, 1 << 20, 16) == \
        jformats.TPDFDitherer(seed=3).dither(0, 1 << 20, 16)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_shaped_dither_matches_jax_with_the_same_seed(rng, request, path):
    """Blocks of a 2-channel stream, the error history carried across
    them, and the scalar hook, on the same path in both packages."""
    if path == "numpy":
        request.getfixturevalue("numpy_paths")
    n, nch, B = 768, 2, 256
    x = rng.uniform(-0.01, 0.01, (n, nch)).astype(np.float32)
    src = x.reshape(-1).view(np.uint8)
    outs = []
    for mod, d in ((host, formats.ShapedDitherer((1.0, -0.5, 0.25), seed=11)),
                   (jhost, jformats.ShapedDitherer((1.0, -0.5, 0.25),
                                                   seed=11))):
        out = np.zeros(n * nch * 2, np.uint8)
        for i in range(0, n, B):
            mod.transfer_samples(src[i * nch * 4:(i + B) * nch * 4], F.FLOAT,
                                 False, 0, nch, out[i * nch * 2:(i + B) * nch * 2],
                                 F.INT16, False, 0, nch, nch, B, ditherer=d)
        outs.append((out, d._ehist.copy(), d.dither(1, 12345 << 8, 16)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def test_shaped_dither_native_matches_its_python_loop(rng):
    data = (rng.integers(-2**26, 2**26, size=400 * 4) << 5).astype(np.int32)
    ch = np.tile(np.arange(4), 400)
    a = formats.ShapedDitherer(shape=(1.0, -0.5, 0.25), seed=11)
    b = formats.ShapedDitherer(shape=(1.0, -0.5, 0.25), seed=11)
    ya = a.dither_block(data, 12, channels=ch)
    orig = native.shaped_dither_block
    native.shaped_dither_block = lambda *args, **kw: None
    try:
        yb = b.dither_block(data, 12, channels=ch)
    finally:
        native.shaped_dither_block = orig
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(a._ehist, b._ehist)


def test_typed_and_linear_transfers_match_jax(rng):
    src = (rng.standard_normal((10, 3)) * 0.4).astype(np.float32)
    for dt in (np.int16, np.int32, np.float64):
        ours, theirs = np.zeros((10, 3), dt), np.zeros((10, 3), dt)
        assert host.transfer_samples_typed(src, 1, ours, 0, 2, 10)
        assert jhost.transfer_samples_typed(src, 1, theirs, 0, 2, 10)
        np.testing.assert_array_equal(ours, theirs)
    raw = _packed(rng, F.INT24, True, 50)
    ours, theirs = np.zeros(200, np.uint8), np.zeros(200, np.uint8)
    host.transfer_samples_linear(raw, F.INT24, True, ours, F.FLOAT, False, 50)
    jhost.transfer_samples_linear(raw, F.INT24, True, theirs, F.FLOAT, False,
                                  50)
    np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(TypeError):
        host.transfer_samples_typed(src, 0, np.zeros((10, 3), np.uint8), 0,
                                    3, 10)


def test_typed_transfer_reads_big_endian_arrays_in_the_port_and_raises_in_jax(
        rng):
    """A reference fault: ``transfer_samples_typed`` reads the byte order
    from the dtypes, but ``sample_format_of`` knows only the native-order
    dtypes, so a big-endian array raises there.  The port reads it."""
    src = rng.integers(-2**15, 2**15, (6, 2)).astype(">i2")
    dst = np.zeros((6, 2), np.int32)
    assert host.transfer_samples_typed(src, 0, dst, 0, 2, 6)
    np.testing.assert_array_equal(dst, src.astype(np.int32) << 16)
    with pytest.raises(TypeError, match="unsupported sample dtypes"):
        jhost.transfer_samples_typed(src, 0, np.zeros((6, 2), np.int32), 0,
                                     2, 6)


@pytest.mark.parametrize("fmt", [F.INT16, F.INT24, F.INT32])
def test_quantize_without_dither_matches_jax_bit_for_bit(rng, fmt):
    x = np.r_[rng.standard_normal(4096) * 0.5, 1.0, -1.0, 1.7, -1.7,
              2.0**-16, -(2.0**-16)].astype(np.float32)
    got = device.quantize(torch.from_numpy(x), fmt).numpy()
    want = np.asarray(jdevice.quantize(jnp.asarray(x), fmt))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_quantize_with_a_generator_keeps_the_dither_contract(rng):
    """``test_tools.py::test_device_quantize_dither``'s contract, with a
    ``torch.Generator`` where JAX takes a PRNG key: a signal far below one
    LSB survives in the noise, unbiased, on the grid; the same seed gives
    the same bits."""
    x = torch.from_numpy((rng.standard_normal(48000) * 1e-4)
                         .astype(np.float32))
    q = device.quantize(x, F.INT16, generator=torch.Generator().manual_seed(0))
    q2 = device.quantize(x, F.INT16,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)
    q = q.numpy()
    assert np.corrcoef(x.numpy(), q)[0, 1] > 0.1
    assert abs(np.mean(q)) < 2**-15
    np.testing.assert_array_equal(q * 2**15, np.round(q * 2**15))
    # JAX's key path keeps the same contract
    qj = np.asarray(jdevice.quantize(jnp.asarray(x.numpy()), F.INT16,
                                     key=jax.random.PRNGKey(0)))
    assert np.corrcoef(x.numpy(), qj)[0, 1] > 0.1
    # the clamp keeps the dither inside int32 at full scale
    edge = torch.tensor([1.0, -1.0, 0.99999], dtype=torch.float32)
    qe = device.quantize(edge, F.INT24, generator=torch.Generator()
                         .manual_seed(1))
    assert bool((qe.abs() <= 1.0).all())


@pytest.mark.parametrize("sfmt,dfmt", list(itertools.product(FORMATS[:4],
                                                             FORMATS[:4])))
def test_convert_matches_jax(rng, sfmt, dfmt):
    if formats.is_sample_integer(sfmt):
        x = rng.integers(-2**31, 2**31, (3, 64)).astype(np.int32)
    else:
        x = (rng.standard_normal((3, 64)) * 0.6).astype(np.float32)
    got = device.convert(torch.from_numpy(x), sfmt, dfmt).numpy()
    want = np.asarray(jdevice.convert(jnp.asarray(x), sfmt, dfmt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sc,dc,n,sfmt,dfmt", [
    (1, 3, 2, F.FLOAT, F.FLOAT), (0, 0, None, F.FLOAT, F.FLOAT),
    (2, 6, 5, F.FLOAT, F.FLOAT), (0, 1, 3, F.INT32, F.FLOAT),
    (1, 0, None, F.FLOAT, F.INT16), (5, 0, 1, F.FLOAT, F.FLOAT),
])
def test_transfer_window_matches_jax(rng, sc, dc, n, sfmt, dfmt):
    if formats.is_sample_integer(sfmt):
        src = rng.integers(-2**31, 2**31, (4, 16)).astype(np.int32)
    else:
        src = (rng.standard_normal((4, 16)) * 0.5).astype(np.float32)
    dst = np.zeros((8, 12), np.int32 if formats.is_sample_integer(dfmt)
                   else np.float32)
    dst_t = torch.from_numpy(dst.copy())
    got = device.transfer_window(torch.from_numpy(src), dst_t, sc, dc, n,
                                 sfmt, dfmt)
    want = jdevice.transfer_window(jnp.asarray(src), jnp.asarray(dst), sc, dc,
                                   n, sfmt, dfmt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dst_t.numpy(), dst)   # dst left as it was


def test_interleave_round_trip_matches_jax(rng):
    x = rng.standard_normal((3, 7)).astype(np.float32)
    got = device.interleave(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdevice.interleave(x)))
    assert torch.equal(device.deinterleave(got), torch.from_numpy(x))
