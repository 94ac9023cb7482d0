"""The port's MatrixConvolver (MIMO/HRTF) against the JAX engine.

The JAX engine runs on an explicit standard-layout spec with every kernel
gate shut (as in ``test_torch_block.py``).  Output and every state leaf
(``queue``, ``prev``, ``step``) are held at >= 110 dB, output against the
float64 golden model at >= 90 dB.  On the CPU the port runs the plain
versions of its transforms (K3 and K4).  The JAX render takes a static
queue write-back when its block count is a multiple of P and a traced one
otherwise; the port's slot is always on the host, so both land on its
static roll, and both are held here, from a nonzero cursor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import MatrixConvolver as JaxMatrixConvolver
from bbcat_dsp_tpu.convolve import matrix as jmatrix
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_torch import MatrixConvolver, ops_hook
from bbcat_dsp_torch.convolve import (
    convolver_init,
    matrix_render,
    partition_ir_matrix,
)
from bbcat_dsp_torch.utils.interop import matrix_state_from_jax, to_numpy
from conftest import snr_db
from test_torch_iir import one_torch_thread  # noqa: F401

B = 32
CI, CO, N = 4, 2, 200    # P = 7 partitions


def _spec():
    return resolve_spectral_spec(2 * B, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def _irs(rng, *shape):
    return rng.standard_normal(shape) * np.exp(-np.arange(shape[-1]) / 60.0)


def _planes(H):
    """The port's filter ``[F, P, C_in, C_out]`` as the JAX package's re/im
    planes ``[2, P, C_in, C_out, F]``."""
    h = H.numpy()
    return np.stack([h.real, h.imag]).transpose(0, 2, 3, 4, 1)


def _pair(irm):
    return (JaxMatrixConvolver(irm, block=B, spectral=_spec()),
            MatrixConvolver(irm, block=B, device="cpu"))


def _assert_states_agree(jconv, tconv):
    js, ts = jconv.state, tconv.state
    assert int(js.step) == ts.step
    for name in ("queue", "prev"):
        want, got = np.asarray(getattr(js, name)), getattr(ts, name)
        assert got.shape == want.shape and got.is_contiguous(), name
        if np.any(want):
            assert snr_db(want, got.numpy()) >= 110.0, name
    assert tconv.H.is_contiguous()
    assert snr_db(np.asarray(jconv.H), _planes(tconv.H)) >= 120.0


def _feed(jconv, tconv, x, method, size, swaps=None):
    """The same pieces of ``x [C_in, T]`` through both engines; output and
    state held after each piece.  ``swaps`` maps a piece index to the
    ``set_filter_matrix`` arguments that precede it."""
    ys = []
    for i in range(x.shape[-1] // size):
        for args, kw in (swaps or {}).get(i, ()):
            jconv.set_filter_matrix(*args, **kw)
            tconv.set_filter_matrix(*args, **kw)
        piece = x[:, i * size:(i + 1) * size]
        yj = np.asarray(getattr(jconv, method)(jnp.asarray(piece)))
        yt = getattr(tconv, method)(torch.from_numpy(piece)).numpy()
        assert yt.shape == yj.shape == (CO, size)
        assert snr_db(yj, yt) >= 110.0
        _assert_states_agree(jconv, tconv)
        ys.append(yt)
    return np.concatenate(ys, -1)


def _golden(x, irm):
    T = x.shape[-1]
    return np.stack([sum(golden.direct_convolve(x[i], irm[i, o])[:T]
                         for i in range(irm.shape[0]))
                     for o in range(irm.shape[1])])


def test_partition_matches_jax(rng):
    irm = _irs(rng, CI, CO, N)
    H = partition_ir_matrix(irm, B, device="cpu")
    Hj = np.asarray(jmatrix.partition_ir_matrix(irm, B, spec=_spec()))
    assert H.shape == (B + 1, 7, CI, CO) and H.dtype == torch.complex64
    assert Hj.shape == (2, 7, CI, CO, B + 1)
    np.testing.assert_array_equal(_planes(H), Hj)
    assert partition_ir_matrix(irm, B, nparts=9, device="cpu").shape[1] == 9
    with pytest.raises(ValueError, match="partitions"):
        partition_ir_matrix(irm, B, nparts=3, device="cpu")


def test_step_stream_with_exchanges_matches_jax_and_golden(rng):
    """Blocks through both engines: a whole-matrix exchange at block 4 and
    stacked per-input exchanges at block 9; the stream is held against the
    golden crossfade model."""
    irm, irm2 = _irs(rng, CI, CO, N), _irs(rng, CI, CO, N)
    new1, new3 = _irs(rng, CO, N), _irs(rng, CO, 90)
    jconv, tconv = _pair(irm)
    nb = 16
    x = rng.standard_normal((CI, nb * B)).astype(np.float32)
    H_before = tconv.H.clone()
    y = _feed(jconv, tconv, x, "process_block", B, {
        4: [((irm2,), {})],
        9: [((new1,), {"in_channel": 1}), ((new3,), {"in_channel": 3})]})
    assert torch.equal(H_before, partition_ir_matrix(irm, B, device="cpu"))
    irm3 = irm2.copy()
    irm3[1] = new1
    irm3[3] = 0.0
    irm3[3, :, :90] = new3
    ya, yb, yc = _golden(x, irm), _golden(x, irm2), _golden(x, irm3)
    ramp = (np.arange(B) + 1.0) / B
    ref = ya.copy()
    ref[:, 4 * B:5 * B] = (1 - ramp) * ya[:, 4 * B:5 * B] + ramp * yb[:, 4 * B:5 * B]
    ref[:, 5 * B:9 * B] = yb[:, 5 * B:9 * B]
    ref[:, 9 * B:10 * B] = (1 - ramp) * yb[:, 9 * B:10 * B] + ramp * yc[:, 9 * B:10 * B]
    ref[:, 10 * B:] = yc[:, 10 * B:]
    assert snr_db(ref, y) >= 90.0


@pytest.mark.parametrize("nblocks", [7, 3, 14, 10])
def test_render_matches_jax_from_a_nonzero_cursor(rng, nblocks):
    """``process`` after 3 blocks (cursor 3 of P = 7): block counts that
    are multiples of P (the JAX static roll) and not (its traced
    write-back), then blocks again."""
    jconv, tconv = _pair(_irs(rng, CI, CO, N))
    assert tconv.nparts == 7
    x = rng.standard_normal((CI, (3 + nblocks + 4) * B)).astype(np.float32)
    _feed(jconv, tconv, x[:, :3 * B], "process_block", B)
    _feed(jconv, tconv, x[:, 3 * B:(3 + nblocks) * B], "process", nblocks * B)
    _feed(jconv, tconv, x[:, (3 + nblocks) * B:], "process_block", B)
    assert tconv.state.step == 3 + nblocks + 4


def test_render_equals_blocks_and_golden(rng):
    irm = _irs(rng, CI, CO, N)
    x = rng.standard_normal((CI, 12 * B)).astype(np.float32)
    a = MatrixConvolver(irm, block=B, device="cpu")
    y_render = a.process(x).numpy()
    b = MatrixConvolver(irm, block=B, device="cpu")
    y_blocks = np.concatenate([b.process_block(x[:, i * B:(i + 1) * B]).numpy()
                               for i in range(12)], -1)
    np.testing.assert_allclose(y_blocks, y_render, atol=2e-5)
    assert snr_db(_golden(x, irm), y_render) >= 90.0
    for name in ("queue", "prev"):
        assert snr_db(getattr(b.state, name).numpy(),
                      getattr(a.state, name).numpy()) >= 110.0


def test_state_stays_contiguous_through_exchanges(rng):
    """Every state tensor contiguous after blocks, exchanges and renders
    (the kernels take contiguous operands only)."""
    conv = MatrixConvolver(_irs(rng, CI, CO, N), block=B, device="cpu")
    x = rng.standard_normal((CI, 5 * B)).astype(np.float32)
    for step in ("block", "swap", "one", "render", "block"):
        if step == "swap":
            conv.set_filter_matrix(_irs(rng, CI, CO, N))
        elif step == "one":
            conv.set_filter_matrix(_irs(rng, CO, N), in_channel=2)
        if step == "render":
            conv.process(x)
        else:
            conv.process_block(x[:, :B])
        assert conv.state.queue.is_contiguous()
        assert conv.state.prev.is_contiguous()
        assert conv.H.is_contiguous()


def test_paths_go_through_the_transforms(rng):
    """A block is K3 and K4 (K4 twice while an exchange fades); a render is
    one K3 and one K4.  No other kernel's plain version runs."""
    conv = MatrixConvolver(_irs(rng, CI, CO, N), block=B, device="cpu")
    x = np.zeros((CI, 4 * B), np.float32)

    def used():
        return {k: v for k, v in ops_hook.counts()["plain"].items() if v}

    ops_hook.reset_counts()
    conv.process_block(x[:, :B])
    assert used() == {"rfft_half": 1, "irfft_tail": 1}
    ops_hook.reset_counts()
    conv.set_filter_matrix(_irs(rng, CI, CO, N))
    conv.process_block(x[:, :B])
    assert used() == {"rfft_half": 1, "irfft_tail": 2}
    ops_hook.reset_counts()
    conv.process(x)
    assert used() == {"rfft_half": 1, "irfft_tail": 1}


def test_reset_and_bad_inputs(rng):
    jconv, tconv = _pair(_irs(rng, CI, CO, N))
    x = rng.standard_normal((CI, 5 * B)).astype(np.float32)
    _feed(jconv, tconv, x, "process", 5 * B)
    irm2 = _irs(rng, CI, CO, N)
    jconv.set_filter_matrix(irm2)
    tconv.set_filter_matrix(irm2)
    jconv.reset()
    tconv.reset()
    assert tconv.state.step == 0 and not tconv.state.queue.any()
    # the exchange scheduled before the reset fades in at the next block
    _feed(jconv, tconv, x, "process_block", B)
    with pytest.raises(ValueError, match="multiple"):
        tconv.process(np.zeros((CI, B + 1)))
    with pytest.raises(ValueError, match="multiple"):
        matrix_render(convolver_init(CI, B, 7, device="cpu"), tconv.H,
                      torch.zeros(CI, 0), B)
    with pytest.raises(ValueError, match="samples"):
        tconv.process_block(np.zeros((CI, 2 * B)))
    with pytest.raises(ValueError, match="expected"):
        tconv.process_block(np.zeros((CI + 1, B)))


def test_stream_crosses_packages(rng):
    """A JAX stream carried across by ``matrix_state_from_jax`` continues in
    the port; the port's state, as numpy leaves, continues in JAX."""
    jconv, tconv = _pair(_irs(rng, CI, CO, N))
    x = rng.standard_normal((CI, 12 * B)).astype(np.float32)
    for i in range(5):
        jconv.process_block(jnp.asarray(x[:, i * B:(i + 1) * B]))
    tconv.H, tconv.state = matrix_state_from_jax(
        np.asarray(jconv.H), jax.tree.map(np.asarray, jconv.state), block=B,
        device="cpu")
    _assert_states_agree(jconv, tconv)
    _feed(jconv, tconv, x[:, 5 * B:9 * B], "process_block", B)
    back = to_numpy(tconv.state)
    jconv.state = type(jconv.state)(jnp.asarray(back.queue),
                                    jnp.asarray(back.prev),
                                    jnp.asarray(back.step, jnp.int32))
    jconv._steps = back.step
    _feed(jconv, tconv, x[:, 9 * B:], "process", 3 * B)
