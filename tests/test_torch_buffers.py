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
