"""The port's two-level render against the JAX engine, end to end.

The JAX engine is built on explicit standard-layout specs with every
kernel gate shut (``mac="0"``, ``fused_head="0"``, ``permfft="0"``): the
``xla`` backend the reference resolves on the CPU, no Pallas interpreter.
Output and every leaf of the final state are held at >= 110 dB (the two
FFT libraries agree to ~135 dB), output against the float64 golden model
at >= 90 dB.  On the CPU the port runs its kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxConvolver
from bbcat_dsp_tpu.convolve import block as jblock
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_tpu.convolve.nonuniform import nonuniform_render as jax_render
from bbcat_dsp_torch import NonUniformConvolver, ops_hook
from bbcat_dsp_torch.convolve import (
    convolver_init,
    nonuniform_render,
    nonuniform_render_looped,
    partition_ir,
)
from bbcat_dsp_torch.convolve.block import _roll_slots
from bbcat_dsp_torch.utils.interop import from_jax_arrays
from conftest import snr_db


def _specs(block: int, ratio: int):
    def spec(n):
        return resolve_spectral_spec(
            n, backend="xla", probe=False, layout="std"
        )._replace(mac="0", fused_head="0", permfft="0")

    return spec(2 * block), spec(2 * block * ratio)


def _leaves(state):
    """The state's array leaves as numpy, by name."""
    f = (lambda a: a.numpy()) if isinstance(state.xcarry, torch.Tensor) \
        else np.asarray
    return {"xcarry": f(state.xcarry), "prev": f(state.prev),
            "tail.queue": f(state.tail.queue), "tail.prev": f(state.tail.prev),
            "pending": f(state.pending)}


def _assert_states_agree(jstate, tstate):
    assert int(jstate.tail.step) == tstate.tail.step
    jl, tl = _leaves(jstate), _leaves(tstate)
    for name in jl:
        assert jl[name].shape == tl[name].shape, name
        assert snr_db(jl[name], tl[name]) >= 110.0, name


# (C, block, ratio, IR taps): Pt = 6 (the render's shape, cut down), Pt = 2
# with odd C, and Pt = 1 (one tail partition)
ENGINES = [(8, 32, 4, 1024), (5, 32, 4, 512), (3, 32, 2, 160)]


@pytest.mark.parametrize("C,B,ratio,N", ENGINES)
def test_render_matches_jax_engine_over_all_branches(rng, C, B, ratio, N):
    """Successive process() calls through the single-group, multi-group
    and per-super-step branches, then a group render at a nonzero queue
    slot: output and final state after each call."""
    ir = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 300.0)
    jconv = JaxConvolver(ir, block=B, ratio=ratio, spectral=_specs(B, ratio))
    tconv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    Pt, SB = tconv.tail_parts, tconv.super_block
    assert Pt == jconv.tail_parts
    nsub = 4 if Pt == 6 else 3         # not a multiple of Pt (Pt > 1)
    for nsup in (Pt, 2 * Pt, nsub, Pt):
        x = rng.standard_normal((C, nsup * SB)).astype(np.float32)
        yj = np.asarray(jconv.process(jnp.asarray(x)))
        yt = tconv.process(torch.from_numpy(x))
        assert yt.shape == yj.shape
        assert snr_db(yj, yt.numpy()) >= 110.0
        _assert_states_agree(jconv.state, tconv.state)


def test_render_matches_jax_dynamic_slot_render(rng):
    """The JAX traced-slot render (``tail_slot0=None``) equals the port,
    whose slot is always the host's ``step % Pt``; the second render starts
    at a nonzero slot."""
    C, B, ratio, N = 4, 32, 4, 1024
    ir = rng.standard_normal((C, N)) * 0.2
    jconv = JaxConvolver(ir, block=B, ratio=ratio, spectral=_specs(B, ratio))
    tconv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    SB, Pt = tconv.super_block, tconv.tail_parts
    js, ts = jconv.state, tconv.state
    for nsup in (4, Pt):
        x = rng.standard_normal((C, nsup * SB)).astype(np.float32)
        js, yj = jax_render(js, jconv.H_head, jconv.H_tail, jnp.asarray(x), B,
                            tail_slot0=None, specs=jconv.specs)
        ts, yt = nonuniform_render(ts, tconv.H_head, tconv.H_tail,
                                   torch.from_numpy(x), B)
        assert snr_db(np.asarray(yj), yt.numpy()) >= 110.0
    assert ts.tail.step % Pt != 0
    _assert_states_agree(js, ts)


def test_stream_matches_golden(rng):
    C, B, ratio = 3, 32, 4
    N = 2 * ratio * B + 3 * ratio * B + 17
    ir = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 300.0)
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    SB, Pt = conv.super_block, conv.tail_parts
    lengths = [Pt * SB, 2 * Pt * SB, 2 * SB]
    x = rng.standard_normal((C, sum(lengths)))
    ys, t0 = [], 0
    for n in lengths:
        ys.append(conv.process(x[:, t0:t0 + n]))
        t0 += n
    y = torch.cat(ys, -1).numpy()
    assert np.all(np.isfinite(y))
    for c in range(C):
        ref = golden.direct_convolve(x[c], ir[c])[:x.shape[1]]
        assert snr_db(ref, y[c]) >= 90.0


def test_render_goes_through_the_six_dispatchers(rng):
    """A group render calls each dispatcher once; a super-step, the head,
    the tail's two transforms and its single-step MAC."""
    conv = NonUniformConvolver(rng.standard_normal((2, 600)), block=32,
                               ratio=4, device="cpu")
    ops_hook.reset_counts()
    conv.process(np.zeros((2, conv.tail_parts * conv.super_block)))
    plain = ops_hook.counts()["plain"]
    assert {k for k, v in plain.items() if v} == {
        "fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
        "gather_supers", "delayed_add"}
    assert set(plain.values()) == {0, 1}
    assert conv.tail_parts > 1
    ops_hook.reset_counts()
    conv.process(np.zeros((2, conv.super_block)))
    plain = ops_hook.counts()["plain"]
    assert {k for k, v in plain.items() if v} == {
        "fused_head", "rfft_half", "xt_step_mac", "irfft_tail"}


def test_looped_render_matches_repeated(rng):
    C, B, ratio = 2, 32, 4
    ir = rng.standard_normal((C, 3 * B * ratio)) * 0.2
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    T = conv.tail_parts * conv.super_block
    xs = torch.from_numpy(rng.standard_normal((3, C, T)).astype(np.float32))
    s1, tails = conv.state, []
    for x in xs:
        s1, y = nonuniform_render(s1, conv.H_head, conv.H_tail, x, B)
        tails.append(y[:, -1])
    s2, looped = nonuniform_render_looped(conv.state, conv.H_head,
                                          conv.H_tail, xs, B)
    assert torch.equal(looped, torch.stack(tails))
    assert s2.tail.step == s1.tail.step == 3 * conv.tail_parts


def test_reset_restarts_the_stream(rng):
    ir = rng.standard_normal((2, 700))
    conv = NonUniformConvolver(ir, block=32, ratio=4, device="cpu")
    x = rng.standard_normal((2, 5 * conv.super_block)).astype(np.float32)
    y1 = conv.process(x)
    conv.process(x)
    conv.reset()
    assert conv.state.tail.step == 0
    assert torch.equal(conv.process(x), y1)


def test_single_ir_broadcasts_to_nchannels(rng):
    ir = rng.standard_normal(700)
    x = rng.standard_normal((3, 6 * 128)).astype(np.float32)
    one = NonUniformConvolver(ir, block=32, ratio=4, nchannels=3,
                              device="cpu")
    each = NonUniformConvolver(np.tile(ir, (3, 1)), block=32, ratio=4,
                               device="cpu")
    assert one.H_tail.shape[2] == 3
    assert torch.equal(one.process(x), each.process(x))


def test_render_refuses_bad_lengths(rng):
    conv = NonUniformConvolver(rng.standard_normal((2, 700)), block=32,
                               ratio=4, device="cpu")
    SB = conv.super_block
    with pytest.raises(ValueError, match="multiple"):
        conv.process(np.zeros((2, SB + 1)))
    with pytest.raises(ValueError, match="multiple"):
        nonuniform_render(conv.state, conv.H_head, conv.H_tail,
                          torch.zeros(2, SB // 2), 32)


def test_engine_tensors_are_contiguous_float32(rng):
    """The kernels take contiguous float32 operands only."""
    conv = NonUniformConvolver(rng.standard_normal((3, 900)), block=32,
                               ratio=4, device="cpu")
    s = conv.state
    for t in (conv.H_head, conv.H_tail, s.xcarry, s.prev, s.tail.queue,
              s.tail.prev, s.pending):
        assert t.is_contiguous() and t.dtype == torch.float32


# ---- block pieces ------------------------------------------------------------

@pytest.mark.parametrize("C,N,block,nparts", [(3, 1000, 64, None),
                                              (1, 100, 32, 4),
                                              (2, 4096, 512, 8)])
def test_partition_ir_matches_jax(rng, C, N, block, nparts):
    ir = rng.standard_normal((C, N))
    spec = resolve_spectral_spec(2 * block, backend="xla", probe=False,
                                 layout="std")
    want = np.asarray(jblock.partition_ir(ir, block, nparts, spec=spec))
    got = partition_ir(ir, block, nparts, device="cpu")
    assert got.shape == want.shape and got.is_contiguous()
    assert snr_db(want, got.numpy()) >= 120.0


def test_partition_ir_refuses_too_few_parts(rng):
    with pytest.raises(ValueError, match="partitions"):
        partition_ir(rng.standard_normal((1, 100)), 32, 2, device="cpu")


def test_convolver_init_and_roll_match_jax(rng):
    st = convolver_init(3, 64, 5, device="cpu")
    jst = jblock.convolver_init(3, 64, 5)
    assert st.queue.shape == jst.queue.shape and st.step == 0
    assert not st.queue.any() and st.prev.shape == jst.prev.shape
    a = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    for shift in range(-1, 7):
        np.testing.assert_array_equal(
            _roll_slots(torch.from_numpy(a), shift).numpy(),
            np.asarray(jblock._roll_slots(jnp.asarray(a), shift)))


# ---- interop -----------------------------------------------------------------

def test_state_carried_over_from_jax_continues_the_stream(rng):
    C, B, ratio, N = 4, 32, 4, 1024
    ir = rng.standard_normal((C, N)) * 0.2
    jconv = JaxConvolver(ir, block=B, ratio=ratio, spectral=_specs(B, ratio))
    SB, Pt = jconv.super_block, jconv.tail_parts
    x1, x2 = rng.standard_normal((2, C, (Pt + 2) * SB)).astype(np.float32)
    jconv.process(jnp.asarray(x1))
    tconv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    tconv.H_head, tconv.H_tail, tconv.state = from_jax_arrays(
        np.asarray(jconv.H_head), np.asarray(jconv.H_tail),
        jax.tree.map(np.asarray, jconv.state), block=B, device="cpu")
    _assert_states_agree(jconv.state, tconv.state)
    yj = np.asarray(jconv.process(jnp.asarray(x2)))
    yt = tconv.process(x2).numpy()
    assert snr_db(yj, yt) >= 110.0
    _assert_states_agree(jconv.state, tconv.state)


def test_interop_refuses_a_permuted_layout_state(rng):
    C, B, ratio, N = 2, 32, 4, 1024
    jconv = JaxConvolver(rng.standard_normal((C, N)), block=B, ratio=ratio,
                         spectral=_specs(B, ratio))
    state = jax.tree.map(np.asarray, jconv.state)
    Hh, Ht = np.asarray(jconv.H_head), np.asarray(jconv.H_tail)
    # a radix-8 permuted tail holds r*(n/r/2 + 1) = n/2 + 8 bins
    pad = [(0, 0)] * 3 + [(0, 7)]
    perm_state = state._replace(tail=state.tail._replace(
        queue=np.pad(state.tail.queue, pad),
        prev=np.pad(state.tail.prev, pad[1:])))
    with pytest.raises(ValueError, match="permuted"):
        from_jax_arrays(Hh, Ht, perm_state, block=B, device="cpu")
    with pytest.raises(ValueError, match="permuted"):
        from_jax_arrays(Hh, np.pad(Ht, pad), state, block=B, device="cpu")
