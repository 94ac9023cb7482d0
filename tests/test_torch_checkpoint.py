"""State files that cross between the two packages, both ways.

For every kind of state (two-level, block and matrix convolver, modal
engine, meter, binaural renderer, ring, ``EQDelayState``, ``BankState``)
the same numpy stream goes through an engine of one package; half-way its
state is written with that package's ``save_state``; a fresh engine of the
other package reads the file with its ``load_state(like=...)`` and
continues.  The joined output is held against the uninterrupted run of the
writing package at >= 110 dB (both packages do the same float32
arithmetic), and the meter's readouts within 0.01 LU.

Also here: the layout of a file the port writes (the JAX package's leaf
count, shapes and dtypes), the permuted spectral layout converted on
reading, older formats refused by number, the reader importing neither JAX
nor the JAX package (a subprocess that forbids both), and the fixture
``tests/data/jax_state_v4.pkl`` that ``chip_smoke.py`` reads on a machine
without JAX.  Write the fixture anew with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_checkpoint.py --write-fixture

from the root of the repo; a test holds the committed one against what
that command writes.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.buffers import ring as jring
from bbcat_dsp_tpu.convolve import BlockConvolver as JBlockConvolver
from bbcat_dsp_tpu.convolve import MatrixConvolver as JMatrixConvolver
from bbcat_dsp_tpu.convolve import NonUniformConvolver as JNonUniformConvolver
from bbcat_dsp_tpu.convolve import fft as jfft
from bbcat_dsp_tpu.filters import bank as jbank
from bbcat_dsp_tpu.filters import iir as jiir
from bbcat_dsp_tpu.loudness import LoudnessMeter as JLoudnessMeter
from bbcat_dsp_tpu.models.binaural import BinauralRenderer as JBinauralRenderer
from bbcat_dsp_tpu.models.pipeline import EQDelayPipeline as JEQDelayPipeline
from bbcat_dsp_tpu.utils import checkpoint as jcheckpoint
from bbcat_dsp_torch import (
    BinauralRenderer,
    BiQuadFilterBank,
    BlockConvolver,
    EQDelayPipeline,
    LoudnessMeter,
    MatrixConvolver,
    NonUniformConvolver,
    load_state,
    save_state,
)
from bbcat_dsp_torch.buffers import ring_init, ring_write
from bbcat_dsp_torch.filters import (
    FilterType,
    bank_init,
    bank_process,
    bank_set_stage,
    modal_apply,
    modal_init,
    modal_params,
)
from bbcat_dsp_torch.utils import checkpoint as tcheckpoint
from conftest import snr_db

FS = 48000.0
DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "jax_state_v4.pkl"
FIXTURE_IO = DATA / "jax_state_v4_io.npz"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def peq(freq, gain):
    return golden.biquad_coeffs(FilterType.PEQ, freq, FS, gain=gain)


def decaying(rng, *shape):
    return rng.standard_normal(shape) * np.exp(-np.arange(shape[-1]) / 60.0)


def tnp(t):
    return t.numpy()


# ---- one stream of each kind, in either package -------------------------------
#
# A kind builds an engine of either package from the same numpy values and
# gives: the blocks to stream, a step ``(engine, block) -> output [.., T]``
# as numpy, and how the engine's state is read and set.

class Kind:
    nblocks = 8

    def __init__(self, rng):
        self.rng = rng

    def get(self, eng):
        return eng.state

    def set(self, eng, state):
        eng.state = state


class TwoLevel(Kind):
    """C = 2, block 32, ratio 2, 3 tail partitions; saved after 5
    super-blocks, so the tail's cursor is off 0."""
    nblocks, stop = 9, 5

    def __init__(self, rng):
        self.ir = decaying(rng, 2, 2 * 2 * 32 + 3 * 64)
        self.x = rng.standard_normal((self.nblocks, 2, 64)).astype(np.float32)

    def jax(self):
        return JNonUniformConvolver(self.ir, block=32, ratio=2)

    def torch(self):
        return NonUniformConvolver(self.ir, block=32, ratio=2, device="cpu")

    def jstep(self, eng, x):
        return np.asarray(eng.process_block(jnp.asarray(x)))

    def tstep(self, eng, x):
        return tnp(eng.process_block(torch.from_numpy(x)))

    def set(self, eng, state):
        eng.state = state
        if hasattr(eng, "_tail_steps"):   # the JAX engine's host mirror
            eng._tail_steps = int(state.tail.step)


class Block(TwoLevel):
    nblocks, stop = 12, 5

    def __init__(self, rng):
        self.ir = decaying(rng, 2, 200)            # 7 partitions
        self.x = rng.standard_normal((self.nblocks, 2, 32)).astype(np.float32)

    def jax(self):
        return JBlockConvolver(self.ir, block=32)

    def torch(self):
        return BlockConvolver(self.ir, block=32, device="cpu")

    def set(self, eng, state):
        eng.state = state
        if hasattr(eng, "_steps"):
            eng._steps = int(state.step)


class Matrix(Block):
    def __init__(self, rng):
        self.ir = decaying(rng, 3, 2, 200)
        self.x = rng.standard_normal((self.nblocks, 3, 32)).astype(np.float32)

    def jax(self):
        return JMatrixConvolver(self.ir, block=32)

    def torch(self):
        return MatrixConvolver(self.ir, block=32, device="cpu")


class Binaural(Block):
    nblocks, stop = 10, 4

    def __init__(self, rng):
        self.ir = decaying(rng, 3, 2, 150)
        self.eq = [peq(1000.0, 4.0), peq(300.0, -3.0)]
        self.x = (rng.standard_normal((self.nblocks, 3, 64)) * 0.3).astype(
            np.float32)

    def jax(self):
        return JBinauralRenderer(self.ir, block=64, eq_stages=self.eq, fs=FS)

    def torch(self):
        return BinauralRenderer(self.ir, block=64, eq_stages=self.eq, fs=FS,
                                device="cpu")

    def set(self, eng, state):
        eng.state = state


class _Functional:
    """An engine made of a pure step and the state it threads."""

    def __init__(self, state, step):
        self.state, self.step = state, step


class Modal(Kind):
    nblocks, stop = 8, 3

    def __init__(self, rng):
        self.c = np.stack([peq(1000.0, 6.0), golden.biquad_coeffs(
            FilterType.LSH, 200.0, FS, gain=3.0)])      # one filter a channel
        self.x = rng.standard_normal((self.nblocks, 2, 100)).astype(np.float32)

    def jax(self):
        p = jiir.modal_params(self.c)
        return _Functional(jiir.modal_init(p, (2,)),
                           lambda x, s: jiir.modal_apply(jnp.asarray(x), p, s))

    def torch(self):
        p = modal_params(self.c, device="cpu")
        return _Functional(modal_init(p, (2,)),
                           lambda x, s: modal_apply(torch.from_numpy(x), p, s))

    def jstep(self, eng, x):
        y, eng.state = eng.step(x, eng.state)
        return np.asarray(y)

    def tstep(self, eng, x):
        y, eng.state = eng.step(x, eng.state)
        return tnp(y)


class RingKind(Modal):
    """A ring of 100 samples written in blocks of 37: the cursor wraps.
    The output of a step is the ring's content after it."""
    nblocks, stop = 7, 4

    def __init__(self, rng):
        self.x = rng.standard_normal((self.nblocks, 2, 37)).astype(np.float32)

    def jax(self):
        def step(x, ring):
            ring = jring.ring_write(ring, jnp.asarray(x))
            return ring.data, ring

        return _Functional(jring.ring_init((2,), 100), step)

    def torch(self):
        def step(x, ring):
            ring = ring_write(ring, torch.from_numpy(x))
            return ring.data, ring

        return _Functional(ring_init((2,), 100, device="cpu"), step)


class Bank(Modal):
    """Two stages over two channels through the float64 ramp engine; a
    ramp of 300 samples set before block 2 and saved 128 samples into
    it."""
    nblocks, stop = 8, 4

    def __init__(self, rng):
        self.c = [peq(500.0, 5.0), peq(4000.0, -3.0), peq(800.0, -6.0)]
        self.x = rng.standard_normal((self.nblocks, 2, 64)).astype(np.float32)

    def _engine(self, init, set_stage, process, to_in):
        st = set_stage(set_stage(init, 0, self.c[0]), 1, self.c[1])
        eng = _Functional(st, None)
        eng.count = 0

        def step(x, state):
            if eng.count == 2:
                state = set_stage(state, 0, self.c[2], 300.0)
            eng.count += 1
            state, y = process(state, to_in(x), engine="assoc_dw")
            return y, state

        eng.step = step
        return eng

    def jax(self):
        return self._engine(jbank.bank_init(2, 2), jbank.bank_set_stage,
                            jbank.bank_process, jnp.asarray)

    def torch(self):
        return self._engine(bank_init(2, 2, device="cpu"), bank_set_stage,
                            bank_process, torch.from_numpy)

    def set(self, eng, state):
        eng.state, eng.count = state, self.stop


class Meter(Kind):
    """Three channels, 0.2 s a call; the output of a step is the three
    readouts after it."""
    nblocks, stop = 12, 7

    def __init__(self, rng):
        self.x = (rng.standard_normal((self.nblocks, 3, 9600)) * 0.1).astype(
            np.float32)

    def jax(self):
        return JLoudnessMeter(3, FS)

    def torch(self):
        return LoudnessMeter(3, FS, device="cpu")

    @staticmethod
    def _readouts(m):
        return np.array([[m.momentary(), m.short_term(), m.integrated()]])

    def jstep(self, eng, x):
        eng.process(jnp.asarray(x))
        return self._readouts(eng)

    def tstep(self, eng, x):
        eng.process(torch.from_numpy(x))
        return self._readouts(eng)


class EQDelay(TwoLevel):
    """Three channels, three stages, block 256, delays on the grid that
    float32 holds exactly (the JAX pipeline's own limit).  ``fallback``
    repeats a stage, which takes the serial modal engine."""
    nblocks, stop = 8, 3
    fallback = False

    def __init__(self, rng):
        eq = np.stack([peq(100.0 * (i + 1), 3.0 * (-1) ** i)
                       for i in range(3)])
        self.eq = np.concatenate([eq[:2], eq[:1]]) if self.fallback else eq
        self.x = rng.standard_normal((self.nblocks, 3, 256)).astype(np.float32)
        self.delays = (rng.integers(20 * 128, 90 * 128, 3) / 128.0
                       + 1.0 / 256.0).astype(np.float32)

    def jax(self):
        return JEQDelayPipeline(self.eq, 3, 256, 100.0, FS)

    def torch(self):
        return EQDelayPipeline(self.eq, 3, 256, 100.0, FS, device="cpu")

    def jstep(self, eng, x):
        return np.asarray(eng.process_block(jnp.asarray(x), self.delays))

    def tstep(self, eng, x):
        return tnp(eng.process_block(x, self.delays))

    def set(self, eng, state):
        eng.state = state


class EQDelayFallback(EQDelay):
    fallback = True


KINDS = {"two-level": TwoLevel, "block": Block, "matrix": Matrix,
         "modal": Modal, "meter": Meter, "binaural": Binaural,
         "ring": RingKind, "eq-delay": EQDelay,
         "eq-delay-fallback": EQDelayFallback, "bank": Bank}


def run(kind, step, eng, lo, hi):
    return [step(eng, kind.x[k]) for k in range(lo, hi)]


def hold(kind_name, whole, joined):
    whole, joined = np.concatenate(whole, -1), np.concatenate(joined, -1)
    assert joined.shape == whole.shape
    if kind_name == "meter":
        # LU readouts: momentary, short-term, integrated after every call
        np.testing.assert_allclose(joined, whole, atol=0.01)
    else:
        assert snr_db(whole, joined) >= 110.0


@pytest.mark.parametrize("name", list(KINDS))
def test_a_file_written_by_jax_resumes_in_the_port(rng, tmp_path, name):
    kind = KINDS[name](rng)
    whole = run(kind, kind.jstep, kind.jax(), 0, kind.nblocks)
    a = kind.jax()
    first = run(kind, kind.jstep, a, 0, kind.stop)
    path = str(tmp_path / "state.pkl")
    jcheckpoint.save_state(path, kind.get(a))
    b = kind.torch()
    kind.set(b, load_state(path, like=kind.get(b)))
    hold(name, whole, first + run(kind, kind.tstep, b, kind.stop,
                                  kind.nblocks))


@pytest.mark.parametrize("name", list(KINDS))
def test_a_file_written_by_the_port_resumes_in_jax(rng, tmp_path, name):
    kind = KINDS[name](rng)
    whole = run(kind, kind.tstep, kind.torch(), 0, kind.nblocks)
    a = kind.torch()
    first = run(kind, kind.tstep, a, 0, kind.stop)
    path = str(tmp_path / "state.pkl")
    save_state(path, kind.get(a))
    b = kind.jax()
    kind.set(b, jcheckpoint.load_state(path, like=kind.get(b)))
    hold(name, whole, first + run(kind, kind.jstep, b, kind.stop,
                                  kind.nblocks))


@pytest.mark.parametrize("name", list(KINDS))
def test_the_ports_file_has_the_jax_packages_leaves(rng, tmp_path, name):
    """Leaf count, shapes and dtypes of a file the port writes equal those
    of the JAX engine's flattened state; ``treedef`` is ``None`` and the
    ``meta`` says format 4, bin order 2, so the JAX reader migrates
    nothing."""
    kind = KINDS[name](rng)
    a = kind.torch()
    run(kind, kind.tstep, a, 0, 2)
    path = str(tmp_path / "state.pkl")
    save_state(path, kind.get(a))
    with open(path, "rb") as fp:
        blob = pickle.load(fp)
    assert blob["treedef"] is None
    assert blob["meta"]["format"] == 4 and blob["meta"]["perm_order"] == 2
    b = kind.jax()
    run(kind, kind.jstep, b, 0, 2)
    want = [np.asarray(leaf) for leaf in jax.tree.leaves(kind.get(b))]
    assert len(blob["leaves"]) == len(want)
    for i, (got, w) in enumerate(zip(blob["leaves"], want)):
        assert isinstance(got, np.ndarray)
        assert got.shape == w.shape and got.dtype == w.dtype, i


def test_a_dict_of_states_round_trips_in_the_port(rng, tmp_path):
    """Nests cross as the JAX package flattens them: a dict by sorted
    keys, tuples and lists in order, ``None`` as no leaf."""
    conv, bank = TwoLevel(rng), Bank(rng)
    a, b = conv.torch(), bank.torch()
    run(conv, conv.tstep, a, 0, 3)
    run(bank, bank.tstep, b, 0, 3)
    tree = {"conv": a.state, "bank": b.state, "more": [None, (a.state.tail, 7)]}
    path = str(tmp_path / "tree.pkl")
    save_state(path, tree)
    like = {"conv": conv.torch().state, "bank": bank.torch().state,
            "more": [None, (conv.torch().state.tail, 0)]}
    got = load_state(path, like=like)
    assert got["more"][0] is None and got["more"][1][1] == 7
    assert got["conv"].tail.step == 3 == got["more"][1][0].step
    assert torch.equal(got["conv"].tail.queue, a.state.tail.queue)
    np.testing.assert_allclose(tnp(got["bank"].targets),
                               tnp(b.state.targets), atol=1e-15)
    # and the JAX package reads the same file into its own nest
    jlike = {"conv": conv.jax().state, "bank": bank.jax().state,
             "more": [None, (conv.jax().state.tail, 0)]}
    jgot = jcheckpoint.load_state(path, like=jlike)
    np.testing.assert_array_equal(np.asarray(jgot["conv"].pending),
                                  tnp(a.state.pending))


# ---- what is refused -------------------------------------------------------------

def test_older_formats_are_refused_by_number(rng, tmp_path):
    kind = Block(rng)
    a = kind.torch()
    path = str(tmp_path / "state.pkl")
    save_state(path, a.state)
    with open(path, "rb") as fp:
        blob = pickle.load(fp)
    for fmt in (1, 2, 3, None):
        blob["meta"] = {"perm_order": 2} if fmt is None else {
            "format": fmt, "perm_order": 2}
        with open(path, "wb") as fp:
            pickle.dump(blob, fp)
        with pytest.raises(ValueError, match=f"format {fmt or 1}"):
            load_state(path, like=a.state)
    blob["meta"] = {"format": 4, "perm_order": 1}
    with open(path, "wb") as fp:
        pickle.dump(blob, fp)
    with pytest.raises(ValueError, match="order 1"):
        load_state(path, like=a.state)


def test_another_states_file_is_refused(rng, tmp_path):
    block, two = Block(rng), TwoLevel(rng)
    path = str(tmp_path / "state.pkl")
    save_state(path, block.torch().state)
    with pytest.raises(ValueError, match="shape|leaves"):
        load_state(path, like=two.torch().state)           # too few
    save_state(path, two.torch().state)
    with pytest.raises(ValueError, match="shape|leaves"):
        load_state(path, like=block.torch().state)         # too many
    other = BlockConvolver(decaying(rng, 2, 100), block=32, device="cpu")
    save_state(path, other.state)                          # 4 partitions
    with pytest.raises(ValueError, match="shape"):
        load_state(path, like=block.torch().state)         # 7 partitions
    with pytest.raises(TypeError):
        save_state(path, {"x": "text"})


# ---- the permuted spectral layout -------------------------------------------------

@pytest.fixture
def force_dftmm(monkeypatch):
    """The JAX package's default transform backend as on a TPU, so states
    are written in the permuted layout (``tests/test_perm_layout.py``)."""
    monkeypatch.setattr(jfft, "default_backend", lambda: "dftmm")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("n,r", [(4096, 16), (8192, 32), (8192, 8),
                                 (16384, 32), (4096, 4)])
def test_unpermute_matches_the_jax_packages(rng, n, r):
    """The port's numpy conversion against ``unpermute_half_spectrum`` and,
    through ``permute_half_spectrum``, back to where it started: exact."""
    std = rng.standard_normal((2, 3, n // 2 + 1)).astype(np.float32)
    perm = jfft.permute_half_spectrum(std[0] + 1j * std[1], n, radix=r)
    planes = np.stack([perm.real, perm.imag]).astype(np.float32)
    assert planes.shape[-1] == r * (n // r // 2 + 1)
    got = tcheckpoint._unpermute(planes, n // 2 + 1)
    np.testing.assert_array_equal(got, std)
    want = jfft.unpermute_half_spectrum(perm, n, radix=r)
    np.testing.assert_array_equal(got[0] + 1j * got[1],
                                  want.astype(np.complex64))
    # no permuted layout of that size: not converted
    assert tcheckpoint._unpermute(planes[..., :-1], n // 2 + 1) is None
    assert tcheckpoint._unpermute(std[..., :1025], 1025) is None


def test_a_permuted_layout_file_resumes_in_the_port(rng, tmp_path, force_dftmm):
    """A ``BlockConvolver`` at block 2048 on the JAX package's matrix
    transforms keeps 16 x 129 = 2064 bins a spectrum where the port keeps
    2049; the file converts on reading and the stream continues at >= 100
    dB (the bar ``tests/test_perm_layout.py`` holds the two layouts to:
    the transforms differ)."""
    B, C = 2048, 2
    ir = rng.standard_normal((C, 3 * B)) * 0.3
    x = rng.standard_normal((C, 6 * B)).astype(np.float32)
    ja = JBlockConvolver(ir, block=B)
    assert ja.state.queue.shape[-1] == 2064
    first = [np.asarray(ja.process_block(jnp.asarray(x[:, k * B:(k + 1) * B])))
             for k in range(3)]
    path = str(tmp_path / "perm.pkl")
    jcheckpoint.save_state(path, ja.state)
    rest = [np.asarray(ja.process_block(jnp.asarray(x[:, k * B:(k + 1) * B])))
            for k in range(3, 6)]
    tb = BlockConvolver(ir, block=B, device="cpu")
    assert tb.state.queue.shape[-1] == 2049
    tb.state = load_state(path, like=tb.state)
    assert tb.state.step == 3
    got = [tnp(tb.process_block(torch.from_numpy(x[:, k * B:(k + 1) * B])))
           for k in range(3, 6)]
    assert snr_db(np.concatenate(rest, -1), np.concatenate(got, -1)) > 100.0
    # the port's file goes back into the permuted-layout engine through
    # the JAX package's own conversion
    save_state(path, tb.state)
    jb = JBlockConvolver(ir, block=B)
    jb.state = jcheckpoint.load_state(path, like=jb.state)
    assert jb.state.queue.shape[-1] == 2064


# ---- the reader needs no JAX -------------------------------------------------------

READER = """
import sys

class Forbid:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "bbcat_dsp_tpu"):
            raise ImportError("forbidden here: " + name)

sys.meta_path.insert(0, Forbid())
import numpy as np
import torch
from bbcat_dsp_torch import NonUniformConvolver, load_state
from bbcat_dsp_torch.filters import bank_init

io = np.load(sys.argv[2])
conv = NonUniformConvolver(io["ir"], block=int(io["block"]),
                           ratio=int(io["ratio"]), device="cpu")
like = {"bank": bank_init(2, 2, device="cpu"), "conv": conv.state}
state = load_state(sys.argv[1], like=like)
assert state["conv"].tail.step == int(io["stop"]), state["conv"].tail.step
assert state["bank"].targets.dtype == torch.float64
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "bbcat_dsp_tpu")]
assert not bad, bad
print("read without jax")
"""


def test_the_reader_imports_neither_jax_nor_the_jax_package():
    """The fixture, written by the JAX package with its tree definition
    and named tuples inside, read in a process in which importing ``jax``,
    ``jaxlib`` or ``bbcat_dsp_tpu`` raises."""
    out = subprocess.run(
        [sys.executable, "-c", READER, str(FIXTURE), str(FIXTURE_IO)],
        capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "read without jax" in out.stdout


# ---- the fixture --------------------------------------------------------------------

def fixture_streams():
    """The fixture's two streams, from a seed: a two-level convolver (C =
    2, block 32, ratio 2, 3 tail partitions) stopped after 5 of 9
    super-blocks, and a bank (2 stages, 2 channels, blocks of 64) stopped
    128 samples into a ramp of 300."""
    rng = np.random.default_rng(2026)
    return TwoLevel(rng), Bank(rng)


def write_fixture(path: Path, io_path: Path) -> None:
    """Stream both in the JAX package, write their states half-way with
    its ``save_state`` as one dict, and keep beside it what a reader needs
    to continue (IRs, coefficients, the blocks after the stop) and the
    JAX package's own output for those blocks."""
    conv, bank = fixture_streams()
    jc, jb = conv.jax(), bank.jax()
    run(conv, conv.jstep, jc, 0, conv.stop)
    run(bank, bank.jstep, jb, 0, bank.stop)
    path.parent.mkdir(exist_ok=True)
    jcheckpoint.save_state(str(path), {"bank": jb.state, "conv": jc.state})
    np.savez(
        io_path, ir=conv.ir, block=32, ratio=2, stop=conv.stop,
        conv_x=conv.x[conv.stop:],
        conv_y=np.stack(run(conv, conv.jstep, jc, conv.stop, conv.nblocks)),
        bank_x=bank.x[bank.stop:],
        bank_y=np.stack(run(bank, bank.jstep, jb, bank.stop, bank.nblocks)))


def test_the_committed_fixture_is_what_the_jax_package_writes(tmp_path):
    write_fixture(tmp_path / "state.pkl", tmp_path / "io.npz")
    assert FIXTURE.stat().st_size < 300_000
    with open(FIXTURE, "rb") as fp:
        have = pickle.load(fp)
    with open(tmp_path / "state.pkl", "rb") as fp:
        want = pickle.load(fp)
    assert have["meta"]["format"] == 4
    assert have["treedef"] == want["treedef"]
    assert len(have["leaves"]) == len(want["leaves"]) == 13
    for a, b in zip(have["leaves"], want["leaves"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    have_io, want_io = np.load(FIXTURE_IO), np.load(tmp_path / "io.npz")
    assert sorted(have_io.files) == sorted(want_io.files)
    for key in want_io.files:
        np.testing.assert_allclose(have_io[key], want_io[key], atol=1e-5)


def test_the_fixture_resumes_in_the_port():
    """What phase 12 of ``chip_smoke.py`` does on the card, here on the
    CPU: the convolver and the bank (through ``restore``) continue from
    the fixture and meet the JAX package's output at >= 110 dB."""
    io = np.load(FIXTURE_IO)
    conv = NonUniformConvolver(io["ir"], block=int(io["block"]),
                               ratio=int(io["ratio"]), device="cpu")
    bank = BiQuadFilterBank(2, 2, fs=FS, device="cpu")
    state = load_state(str(FIXTURE), like={"bank": bank.state,
                                           "conv": conv.state})
    conv.state = state["conv"]
    bank.restore(state["bank"])
    assert bank._ramp_remaining == 172
    y = np.stack([tnp(conv.process_block(torch.from_numpy(x)))
                  for x in io["conv_x"]])
    assert snr_db(io["conv_y"], y) >= 110.0
    y = np.stack([tnp(bank.process(torch.from_numpy(x)))
                  for x in io["bank_x"]])
    assert bank._modal is not None
    assert snr_db(io["bank_y"], y) >= 110.0


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit(__doc__)
    write_fixture(FIXTURE, FIXTURE_IO)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes) and "
          f"{FIXTURE_IO} ({FIXTURE_IO.stat().st_size} bytes)")
