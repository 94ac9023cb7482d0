"""Narrow streams crossing between the packages: a stream that the JAX
package started in bfloat16 or float16 continues in the port through
``utils/interop.py``, and through state files both ways (the JAX
package's file read by the port, the port's by the JAX package), for the
EQ and delay pipeline, the binaural renderer, the meter and the two-level
engine; and the reference fault found on the way, pinned as it is.  The
JAX side runs operation by operation (``jax.disable_jit``), the
semantics the port follows (``test_torch_narrow.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxNonUniform
from bbcat_dsp_tpu.loudness import itu1770 as jloud
from bbcat_dsp_tpu.models import binaural as jbinaural
from bbcat_dsp_tpu.models import pipeline as jpipeline
from bbcat_dsp_tpu.utils import checkpoint as jcheckpoint
from bbcat_dsp_torch import NonUniformConvolver
from bbcat_dsp_torch.loudness import itu1770 as tloud
from bbcat_dsp_torch.models import binaural as tbinaural
from bbcat_dsp_torch.models import pipeline as tpipeline
from bbcat_dsp_torch.utils import interop, load_state, save_state
from conftest import snr_db
from test_torch_iir import one_torch_thread  # noqa: F401
from test_torch_narrow import FS, IDS, NARROW, _f64, _spec, eq_stages
from test_torch_narrow_models import N2, _dtypes, _hrtf, _irs


# ---- crossing over: interop and state files -----------------------------------

def _np_leaves(state):
    return jax.tree.map(np.asarray, state)


class _Kind:
    """One narrow stream in both packages: ``make(dtype)`` builds the JAX
    object or the port's, ``feed(obj, x)`` runs a block, ``state`` /
    ``set_state`` read and write its state, ``convert`` is the interop
    converter of a JAX object's numpy leaves."""

    def __init__(self, make_j, make_t, feed, convert, block, C,
                 get=lambda o: o.state, put=None, db=None):
        self.make_j, self.make_t, self.feed = make_j, make_t, feed
        self.convert, self.block, self.C = convert, block, C
        self.get = get
        self.put = put or (lambda o, s: setattr(o, "state", s))
        self.db = db     # None: bit for bit


def _feed_eq(o, x):
    return o.process_block(x if isinstance(x, jax.Array) else x,
                           np.array([12.5, 30.25], np.float32))


def _feed_meter(o, x):
    o.process(x)
    return jnp.asarray([o.momentary()]) if hasattr(o, "_build_ingest") else \
        torch.tensor([o.momentary()])


H_X = _hrtf(np.random.default_rng(7), 2, 200)
IR_X = _irs(np.random.default_rng(8), 2, N2)

KINDS = {
    "EQDelayPipeline": _Kind(
        lambda d: jpipeline.EQDelayPipeline(eq_stages(3), 2, 128, 40.0, FS,
                                            d),
        lambda d: tpipeline.EQDelayPipeline(eq_stages(3), 2, 128, 40.0, FS,
                                            d, device="cpu"),
        _feed_eq, lambda j: interop.eq_delay_state_from_jax(
            _np_leaves(j.state), device="cpu"), 128, 2),
    "BinauralRenderer": _Kind(
        lambda d: jbinaural.BinauralRenderer(H_X, 64, eq_stages(1), FS,
                                             dtype=d),
        lambda d: tbinaural.BinauralRenderer(H_X, 64, eq_stages(1), FS,
                                             dtype=d, device="cpu"),
        lambda o, x: o.process_block(x),
        lambda j: interop.binaural_state_from_jax(
            np.asarray(j.H), _np_leaves(j.state), block=64, device="cpu")[1],
        64, 2, db=80.0),
    "LoudnessMeter": _Kind(
        lambda d: jloud_meter(d), lambda d: tloud_meter(d), _feed_meter,
        lambda j: interop.meter_state_from_jax(_np_leaves(j.state),
                                               device="cpu"), 1200, 2,
        db=80.0),
    "NonUniformConvolver": _Kind(
        lambda d: JaxNonUniform(IR_X, 16, 4, dtype=d,
                                spectral=(_spec(32), _spec(128))),
        lambda d: NonUniformConvolver(IR_X, 16, 4, dtype=d, device="cpu"),
        lambda o, x: o.process_block(x),
        lambda j: interop.from_jax_arrays(
            np.asarray(j.H_head), np.asarray(j.H_tail), _np_leaves(j.state),
            block=16, device="cpu")[2], 64, 2, db=80.0),
}


def jloud_meter(d):
    return jloud.LoudnessMeter(2, 12000.0, dtype=d)


def tloud_meter(d):
    return tloud.LoudnessMeter(2, 12000.0, dtype=d, device="cpu")


def _jax_started(kind, jdt, rng, nfirst=2, nrest=2):
    """A JAX stream run operation by operation for ``nfirst`` blocks, and
    the blocks still to come."""
    x = (rng.standard_normal((kind.C, (nfirst + nrest) * kind.block))
         * 0.3).astype(np.float32)
    blocks = [x[:, i * kind.block:(i + 1) * kind.block]
              for i in range(nfirst + nrest)]
    j = kind.make_j(jdt)
    with jax.disable_jit():
        for b in blocks[:nfirst]:
            kind.feed(j, jnp.asarray(b))
    return j, blocks[nfirst:]


def _continue_both(kind, j, t, rest):
    for b in rest:
        with jax.disable_jit():
            yj = _f64(kind.feed(j, jnp.asarray(b)))
        yt = _f64(kind.feed(t, torch.from_numpy(b)))
        if kind.db is None:
            np.testing.assert_array_equal(yj, yt)
        else:
            assert snr_db(yj, yt) >= kind.db


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("name", list(KINDS))
@pytest.mark.parametrize("fresh", [False, True],
                         ids=["mid-stream", "fresh"])
def test_a_jax_started_narrow_stream_continues_in_the_port(rng, tdt, jdt,
                                                           name, fresh):
    """Through ``utils/interop.py``: the narrow leaves keep their dtype
    (the two-level engine's non-queue leaves come over as float32: a
    fresh JAX engine's are narrow zeros)."""
    kind = KINDS[name]
    j, rest = _jax_started(kind, jdt, rng, nfirst=0 if fresh else 2)
    t = kind.make_t(tdt)
    st = kind.convert(j)
    if name == "NonUniformConvolver":
        assert st.tail.queue.dtype == tdt
        assert st.xcarry.dtype == st.pending.dtype == torch.float32
    else:
        assert _dtypes(st) == _dtypes(kind.get(j))
    kind.put(t, st)
    _continue_both(kind, j, t, rest)


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
@pytest.mark.parametrize("name", list(KINDS))
def test_narrow_state_files_cross_both_ways(rng, tmp_path, tdt, jdt, name):
    """The JAX package's file read by the port, and the port's file read
    by the JAX package, each continuing the other's stream."""
    kind = KINDS[name]
    j, rest = _jax_started(kind, jdt, rng, nrest=3)
    jcheckpoint.save_state(str(tmp_path / "jax.pkl"), kind.get(j))
    t = kind.make_t(tdt)
    kind.put(t, load_state(str(tmp_path / "jax.pkl"), like=kind.get(t)))
    if name != "NonUniformConvolver":
        assert _dtypes(kind.get(t)) == _dtypes(kind.get(j))
    _continue_both(kind, j, t, rest[:1])
    # and back: the port's file read into the JAX object
    save_state(str(tmp_path / "port.pkl"), kind.get(t))
    back = jcheckpoint.load_state(str(tmp_path / "port.pkl"),
                                  like=kind.get(j))
    kind.put(j, back)
    _continue_both(kind, j, t, rest[1:])


# ---- the reference faults, pinned as they are ------------------------------------

@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_the_references_two_level_reset_widens_the_queue(rng, tdt, jdt):
    """``NonUniformConvolver.reset`` builds the tail queue in the type of
    ``prev`` (``nonuniform.py:858-860``), float32 once a block has run:
    the reference's engine then streams in float32.  The port resets to
    the engine's ``dtype``."""
    x = rng.standard_normal((2, 64)).astype(np.float32)
    jc = JaxNonUniform(IR_X, 16, 4, dtype=jdt)
    jc.process_block(jnp.asarray(x))
    jc.reset()
    assert jc.state.tail.queue.dtype == jnp.float32
    tc = NonUniformConvolver(IR_X, 16, 4, dtype=tdt, device="cpu")
    tc.process_block(x)
    tc.reset()
    assert tc.state.tail.queue.dtype == tdt
    assert tc.state.tail.prev.dtype == torch.float32


@pytest.mark.parametrize("tdt,jdt", NARROW, ids=IDS)
def test_a_fresh_narrow_two_level_state_file_runs_in_the_port(rng, tmp_path,
                                                              tdt, jdt):
    """A fresh narrow JAX engine's file holds every leaf narrow (zeros);
    ``load_state`` keeps a file's narrow leaves, and the port's engine
    widens all but the tail queue before its kernels read them."""
    j = JaxNonUniform(IR_X, 16, 4, dtype=jdt, spectral=(_spec(32), _spec(128)))
    jcheckpoint.save_state(str(tmp_path / "fresh.pkl"), j.state)
    t = NonUniformConvolver(IR_X, 16, 4, dtype=tdt, device="cpu")
    t.state = load_state(str(tmp_path / "fresh.pkl"), like=t.state)
    assert t.state.xcarry.dtype == tdt == t.state.tail.queue.dtype
    x = (rng.standard_normal((2, 3 * 64)) * 0.3).astype(np.float32)
    for k in range(3):
        piece = x[:, k * 64:(k + 1) * 64]
        with jax.disable_jit():
            yj = _f64(j.process_block(jnp.asarray(piece)))
        assert snr_db(yj, _f64(t.process_block(piece))) >= 80.0
        assert t.state.xcarry.dtype == torch.float32
        assert t.state.tail.queue.dtype == tdt
