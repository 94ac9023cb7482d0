"""The port's ring buffer against the JAX package's, exactly.

The same numpy blocks go through ``ring_write`` / ``ring_read_delayed`` /
``ring_advance`` of both packages on the CPU.  The port's write is a
concatenation of slices and the JAX package's a masked select over an
extension: both move samples without arithmetic, so the rings agree bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.buffers import ring as jring
from bbcat_dsp_torch.buffers import (
    Ring,
    ring_advance,
    ring_init,
    ring_read_delayed,
    ring_write,
)
from bbcat_dsp_torch.utils.interop import ring_from_jax, to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(shape, L):
    return jring.ring_init(shape, L), ring_init(shape, L, device="cpu")


def _agree(jr, tr):
    assert int(jr.writepos) == tr.writepos
    np.testing.assert_array_equal(np.asarray(jr.data), tr.data.numpy())


@pytest.mark.parametrize("shape,L,blocks", [
    ((3,), 16, [5, 5, 5, 5, 5]),          # wraps on the fourth write
    ((3,), 16, [16, 16]),                 # B == L: the whole ring
    ((2, 2), 8, [3, 8, 1, 7, 2]),         # two leading axes, mixed sizes
    ((1,), 32, [7, 9]),                   # never wraps
    ((4,), 16, [8, 8, 8]),                # lands exactly on the end
    ((2,), 5, [4, 3, 5, 1, 1, 1]),        # odd length
])
def test_ring_write_matches_jax_exactly(rng, shape, L, blocks):
    jr, tr = _both(shape, L)
    for B in blocks:
        blk = rng.standard_normal(shape + (B,)).astype(np.float32)
        before = tr.data.clone()
        jr = jring.ring_write(jr, jnp.asarray(blk))
        new = ring_write(tr, torch.from_numpy(blk))
        assert torch.equal(tr.data, before)     # the old state is untouched
        tr = new
        _agree(jr, tr)
        assert tr.data.is_contiguous()


def test_ring_write_broadcasts_a_block_over_the_leading_axes(rng):
    jr, tr = _both((3,), 8)
    blk = rng.standard_normal((6,)).astype(np.float32)
    for _ in range(3):
        jr = jring.ring_write(jr, jnp.asarray(blk))
        tr = ring_write(tr, torch.from_numpy(blk))
        _agree(jr, tr)


def test_ring_write_refuses_a_block_longer_than_the_ring():
    jr, tr = _both((2,), 8)
    with pytest.raises(ValueError):
        jring.ring_write(jr, jnp.zeros((2, 9)))
    with pytest.raises(ValueError, match="longer than ring"):
        ring_write(tr, torch.zeros((2, 9)))


@pytest.mark.parametrize("delay,n", [(1, 1), (5, 5), (7, 3), (16, 16),
                                     (3, 1), (12, 9), (20, 4)])
def test_ring_read_delayed_matches_jax_exactly(rng, delay, n):
    jr, tr = _both((3,), 16)
    for B in (7, 6, 9):                       # the cursor ends at 22 % 16 = 6
        blk = rng.standard_normal((3, B)).astype(np.float32)
        jr = jring.ring_write(jr, jnp.asarray(blk))
        tr = ring_write(tr, torch.from_numpy(blk))
    want = np.asarray(jring.ring_read_delayed(jr, delay, n))
    got = ring_read_delayed(tr, delay, n)
    assert got.shape == want.shape
    np.testing.assert_array_equal(want, got.numpy())


def test_ring_read_delayed_refuses_more_than_the_ring_holds():
    tr = ring_init((2,), 8, device="cpu")
    for n in (0, 9):
        with pytest.raises(ValueError):
            ring_read_delayed(tr, 3, n)


def test_ring_advance_skips_without_writing(rng):
    jr, tr = _both((2,), 8)
    blk = rng.standard_normal((2, 5)).astype(np.float32)
    jr = jring.ring_advance(jring.ring_write(jr, jnp.asarray(blk)), 6)
    tr = ring_advance(ring_write(tr, torch.from_numpy(blk)), 6)
    _agree(jr, tr)
    jr = jring.ring_write(jr, jnp.asarray(blk))
    tr = ring_write(tr, torch.from_numpy(blk))
    _agree(jr, tr)


def test_ring_crosses_from_jax_and_back(rng):
    jr = jring.ring_write(jring.ring_init((3,), 8),
                          jnp.asarray(rng.standard_normal((3, 5)), jnp.float32))
    tr = ring_from_jax(Ring(np.asarray(jr.data), np.asarray(jr.writepos)),
                       device="cpu")
    assert isinstance(tr.writepos, int)
    _agree(jr, tr)
    back = to_numpy(tr)
    assert isinstance(back, Ring) and back.writepos == 5
    np.testing.assert_array_equal(back.data, np.asarray(jr.data))


# ---- the delay, FIFO and multilayer buffers ---------------------------------

from bbcat_dsp_tpu.buffers import delay as jdelay  # noqa: E402
from bbcat_dsp_tpu.buffers import multilayer as jmulti  # noqa: E402
from bbcat_dsp_tpu.formats.sample_format import SampleFormat  # noqa: E402
from bbcat_dsp_torch.buffers import (  # noqa: E402
    MultilayerBuffer,
    SoundDelayBuffer,
    SoundRingBuffer,
)
from bbcat_dsp_torch.utils.interop import (  # noqa: E402
    delay_buffer_from_jax,
    multilayer_from_jax,
)


def _blk(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _same_delay(jb, tb):
    assert jb.write_position == tb.write_position and jb.length == tb.length
    np.testing.assert_array_equal(np.asarray(jb.ring.data), tb.ring.data.numpy())


@pytest.mark.parametrize("L,blocks,reads", [
    (64, [32], [(32, 32), (1, 1), (10, 4), (0, 5)]),
    (16, [5, 7, 9, 3], [(16, 16), (5, 9), (3, 3), (12, 1)]),
    (8, [3, 8, 5], [(20, 20), (9, 9), (17, 2)]),   # delays past the length
])
def test_delay_buffer_matches_jax_exactly(rng, L, blocks, reads):
    jb, tb = jdelay.SoundDelayBuffer(3, L), SoundDelayBuffer(3, L, device="cpu")
    for B in blocks:
        x = _blk(rng, (3, B))
        jb.write(jnp.asarray(x))
        tb.write(torch.from_numpy(x))
        _same_delay(jb, tb)
        for delay, n in reads:
            want = np.asarray(jb.read(delay=delay, nframes=n))
            got = tb.read(delay=delay, nframes=n)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
        assert tb.read_sample(2, 3) == jb.read_sample(2, 3)


@pytest.mark.parametrize("L,new", [(32, 64), (32, 20), (16, 16), (24, 7)])
def test_delay_buffer_set_size_matches_jax_exactly(rng, L, new):
    jb, tb = jdelay.SoundDelayBuffer(2, L), SoundDelayBuffer(2, L, device="cpu")
    for B in (7, 11, 5):                            # wraps for L < 23
        x = _blk(rng, (2, B))
        jb.write(jnp.asarray(x))
        tb.write(torch.from_numpy(x))
    jb.set_size(new)
    tb.set_size(new)
    _same_delay(jb, tb)
    x = _blk(rng, (2, 4))
    jb.write(jnp.asarray(x))
    tb.write(torch.from_numpy(x))
    _same_delay(jb, tb)
    np.testing.assert_array_equal(tb.read(min(new, 23), 30).numpy(),
                                  np.asarray(jb.read(min(new, 23), 30)))


@pytest.mark.parametrize("fmt", [SampleFormat.INT16, SampleFormat.INT24,
                                 SampleFormat.INT32, SampleFormat.FLOAT,
                                 SampleFormat.DOUBLE])
@pytest.mark.parametrize("be", [False, True])
def test_delay_buffer_packed_edges_match_jax(rng, fmt, be):
    """Packed frames of 4 channels from channel 1 into a 3-channel buffer,
    and delayed frames back out as packed bytes, in every format."""
    jb, tb = jdelay.SoundDelayBuffer(3, 64), SoundDelayBuffer(3, 64,
                                                              device="cpu")
    frames = (rng.standard_normal((16, 4)) * 0.4).astype(np.float32)
    raw = np.zeros(16 * 4 * [0, 2, 3, 4, 4, 8][fmt], np.uint8)
    from bbcat_dsp_tpu.formats.host import transfer_samples

    transfer_samples(frames.reshape(-1).view(np.uint8), SampleFormat.FLOAT,
                     False, 0, 4, raw, fmt, be, 0, 4, 4, 16)
    for b in (jb, tb):
        b.write_packed(raw, fmt, be, 1, 4, 16)
    _same_delay(jb, tb)
    np.testing.assert_array_equal(tb.read_packed(fmt, be, 16, 12),
                                  jb.read_packed(fmt, be, 16, 12))


def test_int24_packed_round_trip_is_exact_on_the_grid(rng):
    """Values on the INT24 grid survive write_packed / read_packed."""
    tb = SoundDelayBuffer(4, 256, device="cpu")
    v = rng.integers(-2**23, 2**23, (100, 4)).astype(np.int32) << 8
    raw = np.zeros(400 * 3, np.uint8)
    from bbcat_dsp_torch.formats.host import pack

    raw[:] = pack(v.reshape(-1), SampleFormat.INT24)
    tb.write_packed(raw, SampleFormat.INT24, False, 0, 4, 100)
    np.testing.assert_array_equal(
        tb.read_packed(SampleFormat.INT24, False, 100, 100), raw)
    np.testing.assert_array_equal(tb.read(100, 100).numpy().T,
                                  v.astype(np.float64) * 2.0**-31)


def _same_ring(jb, tb):
    _same_delay(jb, tb)
    assert jb.readpos == tb.readpos
    assert jb.read_frames_available() == tb.read_frames_available()
    assert jb.write_frames_available() == tb.write_frames_available()


def test_sound_ring_buffer_matches_jax_exactly(rng):
    """A FIFO sequence with clamped writes and reads, cursor moves and a
    reset, on both packages."""
    jb, tb = jdelay.SoundRingBuffer(2, 16), SoundRingBuffer(2, 16,
                                                            device="cpu")
    _same_ring(jb, tb)
    for op, arg in [("write", 10), ("read", 6), ("write", 20), ("read", 20),
                    ("write", 9), ("inc_read", 4), ("inc_write", 3),
                    ("read", 3), ("write", 13), ("read", 1), ("inc_write", 40),
                    ("read", 16), ("reset", None), ("write", 5), ("read", 7)]:
        if op == "write":
            x = _blk(rng, (2, arg))
            assert tb.write(torch.from_numpy(x)) == jb.write(jnp.asarray(x))
        elif op == "read":
            want = np.asarray(jb.read(arg))
            got = tb.read(arg)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
        elif op == "inc_read":
            assert tb.increment_read_position(arg) == \
                jb.increment_read_position(arg)
        elif op == "inc_write":
            assert tb.increment_write_position(arg) == \
                jb.increment_write_position(arg)
        else:
            jb.reset_positions()
            tb.reset_positions()
        _same_ring(jb, tb)


@pytest.mark.parametrize("fifo", [False, True])
def test_buffers_started_in_jax_continue_in_the_port(rng, fifo):
    cls = jdelay.SoundRingBuffer if fifo else jdelay.SoundDelayBuffer
    jb = cls(3, 16)
    for B in (9, 12):
        jb.write(jnp.asarray(_blk(rng, (3, B))))
    if fifo:
        jb.read(11)
    tb = delay_buffer_from_jax(
        Ring(np.asarray(jb.ring.data), np.asarray(jb.ring.writepos)),
        readpos=jb.readpos if fifo else None, device="cpu")
    assert type(tb) is (SoundRingBuffer if fifo else SoundDelayBuffer)
    for B in (5, 14, 3):
        x = _blk(rng, (3, B))
        assert tb.write(torch.from_numpy(x)) == jb.write(jnp.asarray(x))
        if fifo:
            np.testing.assert_array_equal(tb.read(6).numpy(),
                                          np.asarray(jb.read(6)))
            _same_ring(jb, tb)
        else:
            np.testing.assert_array_equal(tb.read(10, 10).numpy(),
                                          np.asarray(jb.read(10, 10)))
            _same_delay(jb, tb)


def _same_multi(jm, tm):
    assert (jm.capacity, jm.base, jm.readable()) == \
        (tm.capacity, tm.base, tm.readable())
    np.testing.assert_array_equal(jm.positions, tm.positions)
    np.testing.assert_array_equal(np.asarray(jm.data), tm.data.numpy())


def _layer_writes(rng, jm, tm, plan, C):
    for layer, B, mul in plan:
        x = _blk(rng, (C, B))
        jm.write_layer(layer, jnp.asarray(x), mul)
        tm.write_layer(layer, torch.from_numpy(x), mul)
        _same_multi(jm, tm)


@pytest.mark.parametrize("cap,plan,reads", [
    # two producers at blocks of 8 and 12, read whole, slots reused
    (64, [(0, 8, 1.0), (1, 12, 1.0), (0, 8, 1.0), (0, 8, 1.0), (1, 12, 1.0)],
     [24, 5]),
    # three layers with gains, reads that wrap the ring
    (16, [(0, 6, 0.5), (1, 6, 0.3), (2, 6, 1.0), (0, 6, 0.5), (1, 4, 0.3),
          (2, 5, 1.0)], [7, 3, 9]),
    # a producer far ahead of the capacity: the ring doubles twice
    (16, [(0, 64, 1.0), (1, 30, 1.0), (1, 34, 0.25)], [40, 40]),
])
def test_multilayer_buffer_matches_jax_exactly(rng, cap, plan, reads):
    L = max(p[0] for p in plan) + 1
    jm, tm = jmulti.MultilayerBuffer(L, 2, cap), MultilayerBuffer(
        L, 2, cap, device="cpu")
    _layer_writes(rng, jm, tm, plan, 2)
    for n in reads:
        want = np.asarray(jm.read(n))
        got = tm.read(n)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        _same_multi(jm, tm)
        _layer_writes(rng, jm, tm, [(lay, 3, 1.0) for lay in range(L)], 2)


@pytest.mark.parametrize("mix,mul", [(False, 1.0), (True, 1.0), (True, 0.5),
                                     (False, 0.7)])
def test_multilayer_read_into_matches_jax_exactly(rng, mix, mul):
    jm, tm = jmulti.MultilayerBuffer(2, 3, 32), MultilayerBuffer(
        2, 3, 32, device="cpu")
    _layer_writes(rng, jm, tm, [(0, 20, 1.0), (1, 14, 1.0)], 3)
    dst = _blk(rng, (3, 16))
    dst_t = torch.from_numpy(dst.copy())
    got = tm.read_into(dst_t, 16, mix=mix, mul=mul)
    want = jm.read_into(jnp.asarray(dst), 16, mix=mix, mul=mul)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dst_t.numpy(), dst)
    _same_multi(jm, tm)
    jm.reset()
    tm.reset()
    _same_multi(jm, tm)


def test_multilayer_started_in_jax_continues_in_the_port(rng):
    jm = jmulti.MultilayerBuffer(2, 2, 16)
    for layer, B in ((0, 10), (1, 6), (1, 6), (0, 4)):
        jm.write_layer(layer, jnp.asarray(_blk(rng, (2, B))))
    jm.read(7)
    tm = multilayer_from_jax(np.asarray(jm.data), jm.positions, jm.base,
                             device="cpu")
    _same_multi(jm, tm)
    _layer_writes(rng, jm, tm, [(0, 9, 1.0), (1, 12, 0.5), (0, 20, 1.0)], 2)
    np.testing.assert_array_equal(tm.read(30).numpy(), np.asarray(jm.read(30)))
    _same_multi(jm, tm)


def test_multilayer_mixes_convolvers_at_two_block_sizes(rng):
    """``test_buffers_ops.py``'s scenario in the port: two BlockConvolvers
    at blocks 32 and 128 mix into one stream, against the golden sum of
    the two convolutions and against JAX's own mix."""
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.convolve import BlockConvolver as JBlock
    from bbcat_dsp_torch import BlockConvolver
    from conftest import snr_db

    T = 512
    x = rng.standard_normal((2, T)).astype(np.float32)
    ir_a = rng.standard_normal((2, 96)) * 0.3
    ir_b = rng.standard_normal((2, 384)) * 0.2
    mixed = []
    for conv, buf, asarr in (
            ((BlockConvolver(ir_a, block=32, device="cpu"),
              BlockConvolver(ir_b, block=128, device="cpu")),
             MultilayerBuffer(2, 2, 64, device="cpu"), torch.from_numpy),
            ((JBlock(ir_a, block=32), JBlock(ir_b, block=128)),
             jmulti.MultilayerBuffer(2, 2, 64), jnp.asarray)):
        for i in range(T // 128):
            for j in range(4):
                k = 4 * i + j
                buf.write_layer(0, conv[0].process_block(
                    asarr(x[:, k * 32:(k + 1) * 32])))
            buf.write_layer(1, conv[1].process_block(
                asarr(x[:, i * 128:(i + 1) * 128])))
            mixed.append(np.asarray(buf.read(128)))
    ours = np.concatenate(mixed[:T // 128], -1)
    theirs = np.concatenate(mixed[T // 128:], -1)
    for c in range(2):
        ref = (golden.direct_convolve(x[c], ir_a[c])[:T]
               + golden.direct_convolve(x[c], ir_b[c])[:T])
        assert snr_db(ref, ours[c]) > 90.0
        assert snr_db(theirs[c], ours[c]) > 110.0
