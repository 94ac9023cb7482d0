"""The convolvers' ``dtype``: a spectral queue stored in bfloat16 or
float16, against the JAX package's engines built with the same dtype.

What the reference does with a narrow ``dtype`` (``convolve/block.py``):
the queue and the initial ``prev`` are stored in it; a step rounds the new
window into the queue and reads the queue widened to float32; ``prev`` is
float32 once a block has run; a render computes in float32 and rounds only
the queue it carries out.  The port and JAX round the same float32 windows,
which agree to ~135 dB, so their narrow streams differ only where a window
lies at a rounding boundary and the two round it apart: they read
106-137 dB against each other in these tests, held at >= 80 dB.  A port
that ignored ``dtype`` would read infinitely far from its float32 stream;
the narrow stream's distance from float32 (55.8-60.6 dB in bfloat16,
73.7-78.5 dB in float16 here, JAX's the same to 0.01 dB) is held within
3 dB of JAX's.

The refusals (float64, integer types; the narrow two-level engine's
``process`` and ``process_small_block``) and two faults of the reference
are pinned here too, with the
queue crossing ``utils/interop.py`` and state files both ways, and K9's
plain version and gradient over a narrow queue.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.convolve import BlockConvolver as JaxBlockConvolver
from bbcat_dsp_tpu.convolve import MatrixConvolver as JaxMatrixConvolver
from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxNonUniform
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_tpu.ops.pallas import adjoint
from bbcat_dsp_tpu.utils import checkpoint as jcheckpoint
from bbcat_dsp_torch import (
    BlockConvolver,
    MatrixConvolver,
    NonUniformConvolver,
    ops_hook,
)
from bbcat_dsp_torch.convolve import convolver_init
from bbcat_dsp_torch.ops.kernels import spectral_mac as k79
from bbcat_dsp_torch.utils import load_state, save_state
from bbcat_dsp_torch.utils.interop import (
    block_state_from_jax,
    matrix_state_from_jax,
)
from conftest import snr_db
from test_torch_iir import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B = 32
N = 200                  # P = 7 partitions
NARROW = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]
IDS = ["bfloat16", "float16"]


def _spec():
    return resolve_spectral_spec(2 * B, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def _irs(rng, *shape):
    return rng.standard_normal(shape) * np.exp(-np.arange(shape[-1]) / 60.0)


def _bits(a) -> np.ndarray:
    """The stored bits of a narrow array or tensor, to compare exactly."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _run(jconv, tconv, x, plan, swap=None, jtwin=None, ttwin=None):
    """Feed ``x [C, T]`` through both engines (and their float32 twins,
    if given) in ``plan``'s pieces: ``("block", n)`` is n blocks one by
    one, ``("render", n)`` one render of n blocks.  ``swap = (k, ir)``
    schedules an exchange before the k-th block of the stream.  Returns
    the outputs, JAX's first."""
    outs = [[], [], [], []]
    engines = [e for e in (jconv, tconv, jtwin, ttwin)]
    t = 0
    for how, n in plan:
        pieces = ([(t + i * B, B) for i in range(n)] if how == "block"
                  else [(t, n * B)])
        for t0, size in pieces:
            if swap is not None and how == "block" and t0 == swap[0] * B:
                for e in engines:
                    if e is not None:
                        (e.set_filter if hasattr(e, "set_filter")
                         else e.set_filter_matrix)(swap[1])
            piece = x[:, t0:t0 + size]
            call = "process_block" if how == "block" else "process"
            for k, e in enumerate(engines):
                if e is None:
                    continue
                y = getattr(e, call)(jnp.asarray(piece) if k % 2 == 0
                                     else torch.from_numpy(piece))
                outs[k].append(np.asarray(y) if k % 2 == 0 else y.numpy())
        t += n * B
    return [np.concatenate(o, -1) if o else None for o in outs]


PLANS = {"blocks": [("block", 14)],
         "render, blocks, render": [("render", 7), ("block", 9),
                                    ("render", 10)]}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_block_convolver_narrow_queue_matches_jax(rng, tdt, jdt, plan):
    C = 3
    irs, swap_ir = _irs(rng, C, N), _irs(rng, C, N)
    x = rng.standard_normal((C, 40 * B)).astype(np.float32)
    jconv = JaxBlockConvolver(irs, block=B, dtype=jdt, spectral=_spec())
    tconv = BlockConvolver(irs, block=B, dtype=tdt, device="cpu")
    jtwin = JaxBlockConvolver(irs, block=B, spectral=_spec())
    ttwin = BlockConvolver(irs, block=B, device="cpu")
    assert tconv.state.queue.dtype == tdt == tconv.state.prev.dtype
    yj, yt, yj32, yt32 = _run(jconv, tconv, x, PLANS[plan],
                              swap=(11, swap_ir), jtwin=jtwin, ttwin=ttwin)
    assert snr_db(yj, yt) >= 80.0
    assert str(jconv.state.queue.dtype) == str(tconv.state.queue.dtype)[6:]
    assert tconv.state.prev.dtype == torch.float32
    narrow_j, narrow_t = snr_db(yj32, yj), snr_db(yt32, yt)
    assert narrow_t < 100.0 and abs(narrow_t - narrow_j) <= 3.0


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_matrix_convolver_narrow_queue_matches_jax(rng, tdt, jdt):
    Ci, Co = 3, 2
    irm, swap_ir = _irs(rng, Ci, Co, N), _irs(rng, Ci, Co, N)
    x = rng.standard_normal((Ci, 30 * B)).astype(np.float32)
    jconv = JaxMatrixConvolver(irm, block=B, dtype=jdt, spectral=_spec())
    tconv = MatrixConvolver(irm, block=B, dtype=tdt, device="cpu")
    jtwin = JaxMatrixConvolver(irm, block=B, spectral=_spec())
    ttwin = MatrixConvolver(irm, block=B, device="cpu")
    plan = [("render", 7), ("block", 9), ("render", 14)]
    yj, yt, yj32, yt32 = _run(jconv, tconv, x, plan, swap=(10, swap_ir),
                              jtwin=jtwin, ttwin=ttwin)
    assert snr_db(yj, yt) >= 80.0
    assert str(jconv.state.queue.dtype) == str(tconv.state.queue.dtype)[6:]
    narrow_j, narrow_t = snr_db(yj32, yj), snr_db(yt32, yt)
    assert narrow_t < 100.0 and abs(narrow_t - narrow_j) <= 3.0


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16], ids=IDS)
def test_one_fresh_render_rounds_only_the_queue_it_carries_out(rng, tdt):
    """From silence a render reads the narrow queue's zeros, exactly: the
    output is the float32 engine's, bit for bit, and the queue it carries
    out is the float32 one rounded."""
    irs = _irs(rng, 2, N)
    x = torch.from_numpy(rng.standard_normal((2, 9 * B)).astype(np.float32))
    narrow = BlockConvolver(irs, block=B, dtype=tdt, device="cpu")
    wide = BlockConvolver(irs, block=B, device="cpu")
    assert torch.equal(narrow.process(x), wide.process(x))
    assert torch.equal(narrow.state.queue, wide.state.queue.to(tdt))
    assert torch.equal(narrow.state.prev, wide.state.prev)


@pytest.mark.parametrize("bad", [torch.float64, torch.int32, torch.complex64,
                                 np.float32, "bfloat16"])
def test_other_dtypes_are_refused(rng, bad):
    """float64 included: the JAX package with 64-bit types off quietly
    gives float32 there (pinned below); the port refuses it."""
    with pytest.raises(ValueError, match="queue dtype"):
        BlockConvolver(_irs(rng, 2, N), block=B, dtype=bad, device="cpu")
    with pytest.raises(ValueError, match="queue dtype"):
        MatrixConvolver(_irs(rng, 2, 2, N), block=B, dtype=bad, device="cpu")
    with pytest.raises(ValueError, match="queue dtype"):
        convolver_init(2, B, 7, bad, device="cpu")


def test_jax_quietly_makes_float32_of_float64():
    assert not jax.config.jax_enable_x64
    conv = JaxBlockConvolver(np.ones(N), block=B, dtype=jnp.float64)
    assert conv.state.queue.dtype == jnp.float32


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_reset_keeps_the_dtype_in_the_port_and_widens_it_in_jax(rng, tdt,
                                                                jdt):
    """The reference's ``reset`` builds the new queue in ``prev``'s dtype,
    which is float32 once a block has run: its engine then streams in
    float32.  The port resets to the engine's ``dtype``."""
    irs = _irs(rng, 2, N)
    x = rng.standard_normal((2, B)).astype(np.float32)
    for make in (lambda d: JaxBlockConvolver(irs, block=B, dtype=d),
                 lambda d: JaxMatrixConvolver(irs[:, None], block=B,
                                              dtype=d)):
        jconv = make(jdt)
        jconv.process_block(jnp.asarray(x))
        jconv.reset()
        assert jconv.state.queue.dtype == jnp.float32
    for tconv in (BlockConvolver(irs, block=B, dtype=tdt, device="cpu"),
                  MatrixConvolver(irs[:, None], block=B, dtype=tdt,
                                  device="cpu")):
        tconv.process_block(x)
        tconv.reset()
        assert tconv.state.queue.dtype == tdt == tconv.state.prev.dtype


# ---- the two-level engine ------------------------------------------------------

@pytest.mark.parametrize("bad", [torch.bfloat16, torch.float16, torch.float64])
def test_the_two_level_engine_refuses_other_dtypes(rng, bad):
    """float64 is refused at construction; a narrow engine builds and runs
    ``process_block``, and refuses the two paths the reference's narrow
    engine fails in (its ``TypeError``, pinned below) with a
    ``ValueError`` at call time."""
    irs = _irs(rng, 2, N)
    if bad == torch.float64:
        with pytest.raises(ValueError, match="queue dtype"):
            NonUniformConvolver(irs, block=16, ratio=4, dtype=bad,
                                device="cpu")
    else:
        conv = NonUniformConvolver(irs, block=16, ratio=4, dtype=bad,
                                   device="cpu")
        x = rng.standard_normal((2, 64)).astype(np.float32)
        y = conv.process_block(x)
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
        assert conv.state.tail.queue.dtype == bad
        with pytest.raises(ValueError, match="TypeError"):
            conv.process(x)
        with pytest.raises(ValueError, match="TypeError"):
            conv.process_small_block(x[:, :16])
    conv = NonUniformConvolver(irs, 16, 4, None, torch.float32, device="cpu")
    assert conv.state.tail.queue.dtype == torch.float32


@pytest.mark.parametrize("jdt", [jnp.bfloat16, jnp.float16], ids=IDS)
def test_the_references_narrow_two_level_engine_fails_two_of_three_paths(
        rng, jdt):
    """The reference fault the port's refusal answers: the carries of
    ``process`` and ``process_small_block`` change type.  Only
    ``process_block`` runs."""
    irs = _irs(rng, 2, N)
    x = rng.standard_normal((2, 6 * 64)).astype(np.float32)
    with pytest.raises(TypeError, match="carry"):
        JaxNonUniform(irs, 16, 4, dtype=jdt).process(jnp.asarray(x))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JaxNonUniform(irs, 16, 4, dtype=jdt).process_small_block(
            jnp.asarray(x[:, :16]))
    y = JaxNonUniform(irs, 16, 4, dtype=jdt).process_block(
        jnp.asarray(x[:, :64]))
    assert np.all(np.isfinite(np.asarray(y)))


# ---- crossing over: interop and state files ---------------------------------------

def _jax_started(rng, jdt, nblocks=5):
    irs = _irs(rng, 2, N)
    x = rng.standard_normal((2, (nblocks + 6) * B)).astype(np.float32)
    jconv = JaxBlockConvolver(irs, block=B, dtype=jdt, spectral=_spec())
    for i in range(nblocks):
        jconv.process_block(jnp.asarray(x[:, i * B:(i + 1) * B]))
    return irs, x, jconv


def _continue(jconv, tconv, x, first):
    yj, yt = [], []
    for i in range(first, x.shape[-1] // B):
        piece = x[:, i * B:(i + 1) * B]
        yj.append(np.asarray(jconv.process_block(jnp.asarray(piece))))
        yt.append(tconv.process_block(piece).numpy())
    return np.concatenate(yj, -1), np.concatenate(yt, -1)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_jax_started_narrow_stream_continues_in_the_port(rng, tdt, jdt):
    irs, x, jconv = _jax_started(rng, jdt)
    tconv = BlockConvolver(irs, block=B, dtype=tdt, device="cpu")
    tconv.H, tconv.state = block_state_from_jax(
        np.asarray(jconv.H), jax.tree.map(np.asarray, jconv.state), block=B,
        device="cpu")
    assert tconv.state.queue.dtype == tdt
    np.testing.assert_array_equal(_bits(tconv.state.queue),
                                  _bits(jconv.state.queue))
    yj, yt = _continue(jconv, tconv, x, 5)
    assert snr_db(yj, yt) >= 80.0
    jm = JaxMatrixConvolver(irs[:, None], block=B, dtype=jdt)
    jm.process_block(jnp.asarray(x[:, :B]))
    _, st = matrix_state_from_jax(np.asarray(jm.H),
                                  jax.tree.map(np.asarray, jm.state),
                                  block=B, device="cpu")
    assert st.queue.dtype == tdt


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_narrow_state_files_cross_both_ways_bit_for_bit(rng, tmp_path, tdt,
                                                        jdt):
    irs, x, jconv = _jax_started(rng, jdt)
    jcheckpoint.save_state(str(tmp_path / "jax.pkl"), jconv.state)
    tconv = BlockConvolver(irs, block=B, dtype=tdt, device="cpu")
    tconv.state = load_state(str(tmp_path / "jax.pkl"), like=tconv.state)
    assert tconv.state.queue.dtype == tdt
    assert tconv.state.prev.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tconv.state.queue),
                                  _bits(jconv.state.queue))
    np.testing.assert_array_equal(tconv.state.prev.numpy(),
                                  np.asarray(jconv.state.prev))
    yj, yt = _continue(jconv, tconv, x, 5)
    assert snr_db(yj, yt) >= 80.0
    # and back: the port's file, read by the JAX package in its own dtype
    save_state(str(tmp_path / "port.pkl"), tconv.state)
    back = jcheckpoint.load_state(str(tmp_path / "port.pkl"),
                                  like=jconv.state)
    assert back.queue.dtype == jconv.state.queue.dtype == jdt
    np.testing.assert_array_equal(_bits(back.queue), _bits(tconv.state.queue))
    assert int(back.step) == tconv.state.step


WITHOUT_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
sys.modules["jax"] = None
import numpy as np, torch
from bbcat_dsp_torch import BlockConvolver
from bbcat_dsp_torch.utils import load_state, save_state
out, jax_file = sys.argv[1], sys.argv[2]
x = np.ones((2, 32), np.float32)
conv = BlockConvolver(np.ones((2, 40)), 32, dtype=torch.bfloat16, device="cpu")
conv.process_block(x)
for call in (lambda: save_state(out, conv.state),
             lambda: load_state(jax_file, like=conv.state)):
    try:
        call()
    except ImportError as e:
        assert "ml_dtypes" in str(e), e
        print("refused:", e)
    else:
        raise SystemExit("a bfloat16 state crossed without ml_dtypes")
import os
assert not os.path.exists(out)
half = BlockConvolver(np.ones((2, 40)), 32, dtype=torch.float16, device="cpu")
half.process_block(x)
save_state(out, half.state)
got = load_state(out, like=half.state)
assert torch.equal(got.queue, half.state.queue) and got.queue.dtype == torch.float16
print("float16 crossed")
"""


def test_without_ml_dtypes_a_bfloat16_state_is_refused_by_name(rng, tmp_path):
    _, _, jconv = _jax_started(rng, jnp.bfloat16, nblocks=2)
    jcheckpoint.save_state(str(tmp_path / "jax.pkl"), jconv.state)
    res = subprocess.run(
        [sys.executable, "-c", WITHOUT_ML_DTYPES, str(tmp_path / "port.pkl"),
         str(tmp_path / "jax.pkl")], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("refused:") == 2
    assert "float16 crossed" in res.stdout


# ---- K9 over a narrow queue -------------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_rotated_mac_plain_widens_a_narrow_queue(rng, tdt, jdt):
    P, C, F = 5, 3, 17
    q = torch.from_numpy(rng.standard_normal((2, P, C, F)).astype(
        np.float32)).to(tdt)
    H = rng.standard_normal((2, P, C, F)).astype(np.float32)
    ops_hook.reset_counts()
    for slot in range(P):
        got = k79.rotated_mac_plain(q, torch.from_numpy(H), slot)
        want = adjoint.xla_rotated_mac(jnp.asarray(q.float().numpy()),
                                       jnp.asarray(H), slot)
        assert got.dtype == torch.float32
        assert snr_db(np.asarray(want), got.numpy()) >= 110.0
    name = k79.ROTATED_MAC_NAMES[tdt]
    assert ops_hook.counts()["plain"][name] == P
    assert ops_hook.counts()["plain"]["rotated_mac"] == 0


def test_rotated_mac_gradient_in_h_through_a_bfloat16_queue(rng):
    """The queue is state and takes no gradient; H's comes from the plain
    version's vjp on the widened queue, counted as the bfloat16 variant's
    adjoint."""
    P, C, F, slot = 6, 2, 33, 4
    q = torch.from_numpy(rng.standard_normal((2, P, C, F)).astype(
        np.float32)).to(torch.bfloat16)
    H = rng.standard_normal((2, P, C, F)).astype(np.float32)
    g = rng.standard_normal((2, C, F)).astype(np.float32)
    ops_hook.reset_counts()
    Ht = torch.from_numpy(H).requires_grad_()
    (ops_hook.rotated_mac(q, Ht, slot) * torch.from_numpy(g)).sum().backward()
    qw = jnp.asarray(q.float().numpy())
    _, vjp = jax.vjp(lambda h: adjoint.xla_rotated_mac(qw, h, slot),
                     jnp.asarray(H))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    assert snr_db(want, Ht.grad.numpy()) >= 100.0
    counts = ops_hook.counts()
    assert counts["adjoint"]["rotated_mac_bf16"] == 1
    assert counts["plain"]["rotated_mac_bf16"] == 1
