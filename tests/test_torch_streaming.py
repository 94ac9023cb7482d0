"""The port's two-level streaming paths against the JAX engine.

``process_block``, ``process_small_block`` and ``set_filter`` (all
channels and one channel), mixed with ``process``, on the same numpy
inputs through both packages.  The JAX engine runs on explicit
standard-layout specs with every kernel gate shut (as in
``test_torch_nonuniform.py``).  Output and every state leaf are held at
>= 110 dB, output against the float64 golden model at >= 90 dB after an
exchange has settled, and the stream around an exchange to the click
check of ``tests/test_nonuniform.py``.  On the CPU the port runs its
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxConvolver
from bbcat_dsp_torch import NonUniformConvolver, ops_hook
from bbcat_dsp_torch.utils.interop import from_jax_arrays
from conftest import snr_db
from test_torch_nonuniform import _assert_states_agree, _leaves, _specs

B, RATIO = 32, 4
SB = B * RATIO
N = 3 * SB + 40          # Pt = 2 tail partitions past the head


def _pair(ir, ratio=RATIO):
    """The same IRs in a JAX engine and in the port's."""
    return (JaxConvolver(ir, block=B, ratio=ratio, spectral=_specs(B, ratio)),
            NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu"))


def _irs(rng, C, n=N):
    return rng.standard_normal((C, n)) * np.exp(-np.arange(n) / 200.0)


def _run(conv, method, x, size, swaps=None, to_numpy=np.asarray):
    """Feed ``x [C, T]`` to ``conv.<method>`` in pieces of ``size``;
    ``swaps`` maps a piece index to the ``set_filter`` arguments that
    precede it."""
    outs = []
    for i in range(x.shape[-1] // size):
        for args, kw in (swaps or {}).get(i, ()):
            conv.set_filter(*args, **kw)
        piece = x[:, i * size:(i + 1) * size]
        y = getattr(conv, method)(jnp.asarray(piece) if isinstance(
            conv, JaxConvolver) else torch.from_numpy(piece))
        outs.append(to_numpy(y))
    return np.concatenate(outs, -1)


def _torch_np(t):
    return t.numpy()


def _both(jconv, tconv, method, x, size, swaps=None):
    """Run the same stream through both engines; hold output and state."""
    yj = _run(jconv, method, x, size, swaps)
    yt = _run(tconv, method, x, size, swaps, _torch_np)
    assert yt.shape == yj.shape
    assert snr_db(yj, yt) >= 110.0
    _assert_states_agree(jconv.state, tconv.state)
    return yj, yt


# C = 4, and C = 5: an odd channel count, K8's regime in the JAX package
@pytest.mark.parametrize("C", [4, 5])
def test_small_block_stream_matches_jax(rng, C):
    """Five super-blocks of small blocks: output and state after each."""
    jconv, tconv = _pair(_irs(rng, C))
    for _ in range(5):
        x = rng.standard_normal((C, SB)).astype(np.float32)
        _both(jconv, tconv, "process_small_block", x, B)
    assert tconv.state.tail.step == 5 and tconv._sb_fill == 0


@pytest.mark.parametrize("C", [4, 5])
def test_small_block_swap_matches_jax(rng, C):
    """An exchange mid-way through a super-block: the head fades at once,
    the tail at its next firing (the deferred fade)."""
    jconv, tconv = _pair(_irs(rng, C))
    h2 = _irs(rng, C)
    x = rng.standard_normal((C, 5 * SB)).astype(np.float32)
    swaps = {9: [((h2,), {})]}
    _both(jconv, tconv, "process_small_block", x, B, swaps)
    assert tconv._pending_swap is None and tconv._tail_swap is None


@pytest.mark.parametrize("C", [4, 5])
def test_super_block_swap_matches_jax(rng, C):
    jconv, tconv = _pair(_irs(rng, C))
    h2 = _irs(rng, C)
    x = rng.standard_normal((C, 6 * SB)).astype(np.float32)
    _both(jconv, tconv, "process_block", x, SB, {2: [((h2,), {})]})
    np.testing.assert_array_equal(tconv.H_head.numpy(),
                                  np.asarray(jconv.H_head))


def test_stacked_per_channel_swaps_match_jax(rng):
    """Two one-channel exchanges before one block stack; the filter the
    stream runs until then is not touched."""
    C = 4
    jconv, tconv = _pair(_irs(rng, C))
    Hh0 = tconv.H_head.clone()
    g1, g2 = _irs(rng, 1)[0], _irs(rng, 1, n=SB)[0]
    tconv.set_filter(g1, channel=1)
    tconv.set_filter(g2, channel=3)
    assert torch.equal(tconv.H_head, Hh0)
    jconv.set_filter(g1, channel=1)
    jconv.set_filter(g2, channel=3)
    x = rng.standard_normal((C, 5 * SB)).astype(np.float32)
    _both(jconv, tconv, "process_block", x, SB,
          {3: [((_irs(rng, 1)[0],), {"channel": 0})]})
    for name, h in (("H_head", tconv.H_head), ("H_tail", tconv.H_tail)):
        assert snr_db(np.asarray(getattr(jconv, name)), h.numpy()) >= 120.0


def test_mixed_mode_matches_jax(rng):
    """Small blocks, super-blocks and renders in one stream, each starting
    at a super-block boundary, as in ``tests/test_nonuniform.py``'s
    mixed-mode test, with an exchange in each streaming mode."""
    C = 3
    jconv, tconv = _pair(_irs(rng, C))
    Pt = tconv.tail_parts
    steps = [("process_small_block", 2 * SB, B, {3: [((_irs(rng, C),), {})]}),
             ("process", Pt * SB, Pt * SB, None),
             ("process_block", 3 * SB, SB, {1: [((_irs(rng, C),), {})]}),
             ("process", 3 * SB, 3 * SB, None),
             ("process_small_block", SB, B, None),
             ("process", 2 * Pt * SB, 2 * Pt * SB, None)]
    for method, T, size, swaps in steps:
        x = rng.standard_normal((C, T)).astype(np.float32)
        _both(jconv, tconv, method, x, size, swaps)
    assert tconv.state.tail.step == int(jconv.state.tail.step)


def test_owned_tail_queue_stream_matches_jax(rng):
    """A render group, small blocks over three tail firings, super-blocks,
    then an exchange that fades in at the next firing of small blocks:
    output and state against the JAX engine after each.  The queue the
    render left, and each one read from ``state`` to hold it against the
    JAX engine's, is copied once, at the next firing, and never written;
    between two reads the engine writes its own queue in place."""
    C = 3
    jconv, tconv = _pair(_irs(rng, C))
    Pt = tconv.tail_parts

    def x(T):
        return rng.standard_normal((C, T)).astype(np.float32)

    def own_queue_kept(fn):
        """``fn()``'s firings after the first all write one tensor."""
        queues = []
        step = tconv.process_small_block

        def spy(xb):
            y = step(xb)
            if tconv._sb_fill == 0:
                queues.append(tconv._state.tail.queue)
            return y

        tconv.process_small_block = spy
        try:
            fn()
        finally:
            del tconv.process_small_block
        return len(queues) > 1 and all(q is queues[0] for q in queues)

    _both(jconv, tconv, "process", x(Pt * SB), Pt * SB)
    handed = tconv.state.tail.queue
    kept = handed.clone()
    assert own_queue_kept(lambda: _both(jconv, tconv, "process_small_block",
                                        x(3 * SB), B))
    assert tconv._state.tail.queue is not handed
    assert torch.equal(handed, kept)
    handed = tconv.state.tail.queue
    kept = handed.clone()
    _both(jconv, tconv, "process_block", x(2 * SB), SB)
    assert torch.equal(handed, kept)
    assert own_queue_kept(lambda: _both(
        jconv, tconv, "process_small_block", x(2 * SB), B,
        {2: [((_irs(rng, C),), {})]}))
    assert tconv._tail_swap is None
    assert tconv.state.tail.step == int(jconv.state.tail.step)


def test_process_leaves_a_scheduled_exchange_for_later(rng):
    """``process`` renders with the running filters and keeps a scheduled
    exchange for the next streaming block, as the JAX engine does."""
    C = 2
    jconv, tconv = _pair(_irs(rng, C))
    h2 = _irs(rng, C)
    jconv.set_filter(h2)
    tconv.set_filter(h2)
    x = rng.standard_normal((C, 2 * tconv.tail_parts * SB)).astype(np.float32)
    _both(jconv, tconv, "process", x, x.shape[-1])
    assert tconv._pending_swap is not None
    _both(jconv, tconv, "process_block", x[:, :2 * SB], SB)
    assert tconv._pending_swap is None


@pytest.mark.parametrize("method,size", [("process_block", SB),
                                         ("process_small_block", B)])
def test_streaming_equals_render(rng, method, size):
    C = 2
    ir = _irs(rng, C)
    x = rng.standard_normal((C, 5 * SB)).astype(np.float32)
    y_render = NonUniformConvolver(ir, block=B, ratio=RATIO,
                                   device="cpu").process(x).numpy()
    conv = NonUniformConvolver(ir, block=B, ratio=RATIO, device="cpu")
    y = _run(conv, method, x, size, to_numpy=_torch_np)
    np.testing.assert_allclose(y, y_render, atol=2e-5)


@pytest.mark.parametrize("method,size,at", [("process_block", SB, 3),
                                            ("process_small_block", B, 9)])
def test_swap_is_click_free_and_settles_to_the_new_ir(rng, method, size, at):
    """The ``tests/test_nonuniform.py`` swap contract: pure ``h2`` once
    the tail's delay has passed, and no discontinuity anywhere."""
    T = 8 * SB
    h1, h2 = rng.standard_normal((2, 3 * SB)) * 0.3
    x = rng.standard_normal((1, T)).astype(np.float32)
    conv = NonUniformConvolver(h1, block=B, ratio=RATIO, device="cpu")
    y = _run(conv, method, x, size, {at: [((h2,), {})]},
             to_numpy=_torch_np)[0]
    swap = at * size
    assert snr_db(golden.direct_convolve(x[0], h1)[:swap], y[:swap]) >= 90.0
    settle = 6 * SB
    ref = golden.direct_convolve(x[0], h2)[:T]
    assert snr_db(ref[settle:], y[settle:]) >= 90.0
    d = np.abs(np.diff(y))
    assert d.max() < 20 * np.median(np.abs(y) + 1e-9)


def test_per_channel_swap_settles_against_golden(rng):
    T = 8 * SB
    h = rng.standard_normal((2, 3 * SB)) * 0.3
    h1 = rng.standard_normal(3 * SB) * 0.3
    x = rng.standard_normal((2, T)).astype(np.float32)
    conv = NonUniformConvolver(h, block=B, ratio=RATIO, device="cpu")
    y = _run(conv, "process_block", x, SB, {3: [((h1,), {"channel": 1})]},
             to_numpy=_torch_np)
    settle = 6 * SB
    for c, ir in ((0, h[0]), (1, h1)):
        ref = golden.direct_convolve(x[c], ir)[:T]
        assert snr_db(ref[settle:], y[c, settle:]) >= 90.0


def test_state_stays_contiguous_through_exchanges(rng):
    """The kernels take contiguous operands only, so every state tensor
    the streaming paths leave behind is contiguous."""
    C = 3
    conv = NonUniformConvolver(_irs(rng, C), block=B, ratio=RATIO,
                               device="cpu")
    x = rng.standard_normal((C, 4 * SB)).astype(np.float32)
    _run(conv, "process_small_block", x[:, :2 * SB], B,
         {2: [((_irs(rng, C),), {})]}, _torch_np)
    _run(conv, "process_block", x[:, 2 * SB:], SB,
         {0: [((_irs(rng, 1)[0],), {"channel": 2})]}, _torch_np)
    s = conv.state
    for t in (conv.H_head, conv.H_tail, s.xcarry, s.prev, s.tail.queue,
              s.tail.prev, s.pending):
        assert t.is_contiguous() and t.dtype == torch.float32


def test_small_block_path_goes_through_head_mac(rng):
    """A small block is K3, K7, K4; the block that completes a super-block
    adds the tail's K3, K2s, K4.  No render kernel runs."""
    C = 2
    conv = NonUniformConvolver(_irs(rng, C), block=B, ratio=RATIO,
                               device="cpu")
    x = rng.standard_normal((C, SB)).astype(np.float32)
    ops_hook.reset_counts()
    conv.process_small_block(x[:, :B])
    assert {k: v for k, v in ops_hook.counts()["plain"].items() if v} == {
        "rfft_half": 1, "head_mac": 1, "irfft_tail": 1}
    for i in range(1, RATIO):
        conv.process_small_block(x[:, i * B:(i + 1) * B])
    assert {k: v for k, v in ops_hook.counts()["plain"].items() if v} == {
        "rfft_half": RATIO + 1, "head_mac": RATIO, "xt_step_mac": 1,
        "irfft_tail": RATIO + 1}


def test_process_block_refuses_a_partial_super_block(rng):
    conv = NonUniformConvolver(_irs(rng, 2), block=B, ratio=RATIO,
                               device="cpu")
    with pytest.raises(ValueError, match="samples"):
        conv.process_block(np.zeros((2, SB - 1)))
    with pytest.raises(ValueError, match="samples"):
        conv.process_small_block(np.zeros((2, 2 * B)))
    conv.process_small_block(np.zeros((2, B)))
    with pytest.raises(ValueError, match="mid-way"):
        conv.process_block(np.zeros((2, SB)))


def test_reset_lands_a_scheduled_exchange(rng):
    """After ``reset`` the stream restarts from silence on the newest
    filters: a scheduled exchange, or one whose tail half had not fired
    yet, has nothing left to fade from."""
    C = 2
    h1, h2 = _irs(rng, C), _irs(rng, C)
    x = rng.standard_normal((C, 3 * SB)).astype(np.float32)
    fresh = _run(NonUniformConvolver(h2, block=B, ratio=RATIO, device="cpu"),
                 "process_small_block", x, B, to_numpy=_torch_np)
    conv = NonUniformConvolver(h1, block=B, ratio=RATIO, device="cpu")
    conv.set_filter(h2)
    conv.reset()
    np.testing.assert_array_equal(
        _run(conv, "process_small_block", x, B, to_numpy=_torch_np), fresh)
    conv = NonUniformConvolver(h1, block=B, ratio=RATIO, device="cpu")
    conv.set_filter(h2)
    conv.process_small_block(x[:, :B])       # head swapped, tail pending
    assert conv._tail_swap is not None
    conv.reset()
    assert conv._tail_swap is None and conv._sb_fill == 0
    assert not conv._sb_buf.any()
    np.testing.assert_array_equal(
        _run(conv, "process_small_block", x, B, to_numpy=_torch_np), fresh)


def test_small_block_stream_carried_over_from_jax(rng):
    """A JAX small-block stream crosses at a super-block boundary and
    continues in the port."""
    C = 3
    ir = _irs(rng, C)
    jconv, tconv = _pair(ir)
    x1, x2 = rng.standard_normal((2, C, 2 * SB)).astype(np.float32)
    _run(jconv, "process_small_block", x1, B)
    assert jconv._sb_fill == 0
    tconv.H_head, tconv.H_tail, tconv.state = from_jax_arrays(
        np.asarray(jconv.H_head), np.asarray(jconv.H_tail),
        jax.tree.map(np.asarray, jconv.state), block=B, device="cpu")
    _both(jconv, tconv, "process_small_block", x2, B)
    assert set(_leaves(tconv.state)) == set(_leaves(jconv.state))
