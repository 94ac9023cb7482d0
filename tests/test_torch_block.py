"""The port's BlockConvolver (uniform partitions) against the JAX engine.

The JAX engine runs on an explicit standard-layout spec with every kernel
gate shut (as in ``test_torch_nonuniform.py``).  Output and every state
leaf (``queue``, ``prev``, ``step``) are held at >= 110 dB, output against
the float64 golden model at >= 90 dB.  On the CPU the port runs its
kernels' plain versions: the rotated MAC (K9) in the per-block step, the
head MAC (K7) in the render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import BlockConvolver as JaxBlockConvolver
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_torch import BlockConvolver, ops_hook
from bbcat_dsp_torch.convolve import convolver_init, convolver_render
from bbcat_dsp_torch.utils.interop import block_state_from_jax
from conftest import snr_db

B = 32
N = 200                  # P = 7 partitions


def _spec():
    return resolve_spectral_spec(2 * B, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def _pair(ir, **kw):
    return (JaxBlockConvolver(ir, block=B, spectral=_spec(), **kw),
            BlockConvolver(ir, block=B, device="cpu", **kw))


def _irs(rng, *shape):
    n = shape[-1]
    return rng.standard_normal(shape) * np.exp(-np.arange(n) / 60.0)


def _assert_states_agree(jconv, tconv):
    js, ts = jconv.state, tconv.state
    assert int(js.step) == ts.step
    for name in ("queue", "prev"):
        want, got = np.asarray(getattr(js, name)), getattr(ts, name)
        assert got.shape == want.shape and got.is_contiguous(), name
        assert snr_db(want, got.numpy()) >= 110.0, name


def _feed(jconv, tconv, x, method, size, swaps=None):
    """The same pieces of ``x [..., T]`` through both engines; output and
    state held after each piece.  ``swaps`` maps a piece index to the
    ``set_filter`` arguments that precede it."""
    for i in range(x.shape[-1] // size):
        for args, kw in (swaps or {}).get(i, ()):
            jconv.set_filter(*args, **kw)
            tconv.set_filter(*args, **kw)
        piece = x[..., i * size:(i + 1) * size]
        yj = np.asarray(getattr(jconv, method)(jnp.asarray(piece)))
        yt = getattr(tconv, method)(torch.from_numpy(piece)).numpy()
        assert yt.shape == yj.shape
        assert snr_db(yj, yt) >= 110.0
        _assert_states_agree(jconv, tconv)


@pytest.mark.parametrize("C", [3, 4])
def test_block_stream_with_swap_matches_jax(rng, C):
    jconv, tconv = _pair(_irs(rng, C, N))
    x = rng.standard_normal((C, 12 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process_block", B, {5: [((_irs(rng, C, N),), {})]})
    assert tconv._pending_H is None and tconv.state.step == 12


def test_mono_block_input_matches_jax(rng):
    """A ``[N]`` IR and ``[B]`` blocks give ``[B]`` blocks back."""
    jconv, tconv = _pair(_irs(rng, N))
    x = rng.standard_normal(9 * B).astype(np.float32)
    _feed(jconv, tconv, x, "process_block", B, {4: [((_irs(rng, N),), {})]})
    assert tconv.process_block(x[:B]).shape == (B,)
    assert tconv.process(x[:2 * B]).shape == (2 * B,)


def test_render_matches_jax_at_either_write_back(rng):
    """``process`` continues a block stream.  The JAX engine takes its
    static write-back when the block count is a multiple of P and its
    traced one when it is not; the port's slot is always on the host, so
    both land on its static roll."""
    C = 3
    jconv, tconv = _pair(_irs(rng, C, N))
    P = tconv.nparts
    x = rng.standard_normal((C, 3 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process_block", B)
    for n in (P, 3, 2 * P, 10):
        x = rng.standard_normal((C, n * B)).astype(np.float32)
        _feed(jconv, tconv, x, "process", n * B)
        assert tconv.state.step % P != 0
    x = rng.standard_normal((C, 4 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process_block", B)


def test_stacked_per_channel_swaps_match_jax(rng):
    C = 4
    jconv, tconv = _pair(_irs(rng, C, N))
    H0 = tconv.H.clone()
    g1, g2 = _irs(rng, N), _irs(rng, 70)
    tconv.set_filter(g1, channel=1)
    tconv.set_filter(g2, channel=3)
    assert torch.equal(tconv.H, H0)      # the running filter is untouched
    jconv.set_filter(g1, channel=1)
    jconv.set_filter(g2, channel=3)
    x = rng.standard_normal((C, 8 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process_block", B,
          {4: [((_irs(rng, N),), {"channel": 0})]})
    assert snr_db(np.asarray(jconv.H), tconv.H.numpy()) >= 120.0


def test_swap_matches_golden_crossfade(rng):
    T, swap_block = 12 * B, 5
    h_old, h_new = _irs(rng, N), _irs(rng, N)
    x = rng.standard_normal(T)
    ref = golden.crossfade_swap_convolve(x, h_old, h_new, B, swap_block)
    conv = BlockConvolver(h_old, block=B, device="cpu")
    outs = []
    for i in range(T // B):
        if i == swap_block:
            conv.set_filter(h_new)
        outs.append(conv.process_block(x[i * B:(i + 1) * B]).numpy())
    assert snr_db(ref, np.concatenate(outs)) >= 90.0


def test_render_and_stream_match_golden(rng):
    C, T = 2, 10 * B
    irs = _irs(rng, C, N)
    x = rng.standard_normal((C, T))
    y = BlockConvolver(irs, block=B, device="cpu").process(x).numpy()
    conv = BlockConvolver(irs, block=B, device="cpu")
    ys = np.concatenate([conv.process_block(x[:, i * B:(i + 1) * B]).numpy()
                         for i in range(T // B)], -1)
    np.testing.assert_allclose(ys, y, atol=2e-5)
    for c in range(C):
        ref = golden.direct_convolve(x[c], irs[c])[:T]
        assert snr_db(ref, y[c]) >= 90.0
        assert snr_db(ref, ys[c]) >= 90.0


def test_reset_matches_jax(rng):
    """``reset`` restarts the stream; an exchange scheduled before it
    still fades in at the next block, as in the JAX engine."""
    C = 2
    jconv, tconv = _pair(_irs(rng, C, N))
    x = rng.standard_normal((C, 5 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process", 5 * B)
    h2 = _irs(rng, C, N)
    jconv.set_filter(h2)
    tconv.set_filter(h2)
    jconv.reset()
    tconv.reset()
    assert tconv.state.step == 0 and not tconv.state.queue.any()
    _feed(jconv, tconv, x, "process_block", B)
    fresh = BlockConvolver(h2, block=B, device="cpu")
    tconv.reset()
    assert torch.equal(tconv.process(x), fresh.process(x))


def test_block_paths_go_through_their_macs(rng):
    """A block is K3, K9, K4 (K9 twice while an exchange fades); a render
    is K3, K7, K4."""
    C = 2
    conv = BlockConvolver(_irs(rng, C, N), block=B, device="cpu")
    x = np.zeros((C, 4 * B), np.float32)

    def used():
        return {k: v for k, v in ops_hook.counts()["plain"].items() if v}

    ops_hook.reset_counts()
    conv.process_block(x[:, :B])
    assert used() == {"rfft_half": 1, "rotated_mac": 1, "irfft_tail": 1}
    ops_hook.reset_counts()
    conv.set_filter(_irs(rng, C, N))
    conv.process_block(x[:, :B])
    assert used() == {"rfft_half": 1, "rotated_mac": 2, "irfft_tail": 2}
    ops_hook.reset_counts()
    conv.process(x)
    assert used() == {"rfft_half": 1, "head_mac": 1, "irfft_tail": 1}


def test_render_refuses_bad_lengths(rng):
    conv = BlockConvolver(_irs(rng, 2, N), block=B, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        conv.process(np.zeros((2, B + 1)))
    with pytest.raises(ValueError, match="multiple"):
        convolver_render(convolver_init(2, B, 3, device="cpu"), conv.H,
                         torch.zeros(2, 0), B)
    with pytest.raises(ValueError, match="samples"):
        conv.process_block(np.zeros((2, 2 * B)))


def test_block_state_carried_over_from_jax(rng):
    """A JAX BlockConvolver stream, carried across by
    ``block_state_from_jax``, continues in the port."""
    C = 3
    ir = _irs(rng, C, N)
    jconv, tconv = _pair(ir)
    x = rng.standard_normal((C, 9 * B)).astype(np.float32)
    for i in range(5):
        jconv.process_block(jnp.asarray(x[:, i * B:(i + 1) * B]))
    tconv.H, tconv.state = block_state_from_jax(
        np.asarray(jconv.H), jax.tree.map(np.asarray, jconv.state), block=B,
        device="cpu")
    _assert_states_agree(jconv, tconv)
    _feed(jconv, tconv, x[:, 5 * B:], "process_block", B)
    pad = [(0, 0)] * 3 + [(0, 7)]
    with pytest.raises(ValueError, match="permuted"):
        block_state_from_jax(np.pad(np.asarray(jconv.H), pad),
                             jax.tree.map(np.asarray, jconv.state), block=B,
                             device="cpu")
