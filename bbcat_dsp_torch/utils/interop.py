"""Carry IR spectra and streaming state over from the JAX package.

:func:`from_jax_arrays` takes the two-level engine's ``H_head``, ``H_tail``
and ``NonUniformState``, :func:`block_state_from_jax` a ``BlockConvolver``'s
``H`` and ``ConvolverState`` (:func:`matrix_state_from_jax` a
``MatrixConvolver``'s), :func:`eq_delay_state_from_jax` an
``EQDelayPipeline``'s ``EQDelayState``, :func:`bank_state_from_jax` a
filter bank's ``BankState``, and the small ops' objects (the delay and
ring buffers, the multilayer buffer, the running average's and the
histogram's states, the interpolators), with every leaf already a numpy
array (for
example ``jax.tree.map(np.asarray, conv.state)``), and each returns the
port's tensors on ``device``, so a stream started in one package continues
in the other.  A two-level stream crosses at a super-block boundary: the
small-block path's partly filled super-block (``_sb_buf``, ``_sb_fill``) is
not part of the state.  Only the standard spectral layout crosses here: a
permuted-layout spectrum (``r * (n/r/2 + 1)`` bins instead of ``n/2 + 1``)
is refused; a state file of that layout is converted when it is read
(:mod:`~bbcat_dsp_torch.utils.checkpoint`).  A leaf that an engine built
with a narrow ``dtype`` stores narrow keeps its dtype, float16 or
bfloat16 (an ``ml_dtypes`` array on the JAX side, carried over by its
bits): a block or matrix convolver's queue and ``prev``, a ring's data,
a modal engine's parameters and state, the meter's tail and filter
states, the EQ's.  The two-level engine's tail queue keeps its dtype;
its other leaves come over as float32, as the port stores them (a fresh
narrow JAX engine holds them narrow, all zeros, so this is exact).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convolve.block import ConvolverState
from ..convolve.fft import spectral_nbins
from ..convolve.matrix import filter_from_planes
from ..convolve.nonuniform import NonUniformState
from ..analysis import HistogramState, RunningAverageState
from ..buffers.delay import SoundDelayBuffer, SoundRingBuffer
from ..buffers.multilayer import MultilayerBuffer
from ..buffers.ring import Ring
from ..filters.bank import BankState
from ..filters.iir import ModalParams, ModalState, ParallelCascadeState
from ..loudness.itu1770 import MeterState
from ..models.binaural import BinauralState
from ..models.pipeline import EQDelayState
from ..ops.interpolator import ComplexInterpolator, Interpolator

__all__ = ["from_jax_arrays", "block_state_from_jax", "matrix_state_from_jax",
           "modal_from_jax", "meter_state_from_jax", "binaural_state_from_jax",
           "ring_from_jax", "eq_delay_state_from_jax", "bank_state_from_jax",
           "bank_state_to_jax", "to_numpy", "delay_buffer_from_jax",
           "multilayer_from_jax", "running_average_state_from_jax",
           "histogram_state_from_jax", "interpolator_from_jax",
           "complex_interpolator_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    # a copy: arrays that come from JAX are read-only
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)


def narrow_tensor(a) -> torch.Tensor | None:
    """A float16 or bfloat16 (``ml_dtypes``) array as a CPU tensor of its
    own dtype, bit for bit; ``None`` for any other dtype."""
    a = np.asarray(a)
    if a.dtype == np.float16:
        return torch.from_numpy(np.array(a, order="C"))
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return None


def _leaf(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``: a narrow one in its own
    dtype, bit for bit, any other as float32."""
    t = narrow_tensor(a)
    return _tensor(a, device) if t is None else t.to(device)


def _planes(a, name: str, nbins: int, n: int, device,
            keep_narrow: bool = False) -> torch.Tensor:
    shape = np.shape(a)
    if shape[0] != 2 or shape[-1] != nbins:
        raise ValueError(
            f"{name}: shape {shape}, expected [2, ..., {nbins}] -- the "
            f"standard layout at FFT size {n} (a permuted-layout state does "
            "not fit the port)")
    return _leaf(a, device) if keep_narrow else _tensor(a, device)


def from_jax_arrays(H_head, H_tail, state, *, block: int, device):
    """``(H_head, H_tail, NonUniformState)`` as tensors on ``device``.

    ``state`` has the JAX ``NonUniformState``'s fields (``xcarry``,
    ``prev``, ``tail`` with ``queue``/``prev``/``step``, ``pending``) as
    numpy arrays; ``block`` is the head's block size.  A narrow tail queue
    stays narrow, every other leaf comes over as float32."""
    B2 = np.shape(state.pending)[-1]
    nh, nt = 2 * block, 2 * B2
    Fh, Ft = spectral_nbins(nh), spectral_nbins(nt)
    st = NonUniformState(
        xcarry=_planes(state.xcarry, "xcarry", Fh, nh, device),
        prev=_planes(state.prev, "prev", Fh, nh, device),
        tail=ConvolverState(
            queue=_planes(state.tail.queue, "tail.queue", Ft, nt, device,
                          keep_narrow=True),
            prev=_planes(state.tail.prev, "tail.prev", Ft, nt, device),
            step=int(np.asarray(state.tail.step)),
        ),
        pending=_tensor(state.pending, device),
    )
    return (_planes(H_head, "H_head", Fh, nh, device),
            _planes(H_tail, "H_tail", Ft, nt, device), st)


def block_state_from_jax(H, state, *, block: int, device):
    """``(H, ConvolverState)`` of a ``BlockConvolver`` (``H [2, P, C, F]``)
    as tensors on ``device``; ``state`` has ``queue``, ``prev`` and
    ``step`` as numpy arrays and ``block`` is the engine's block size.
    The queue and ``prev`` keep a bfloat16 or float16 dtype (an engine
    built with that ``dtype``)."""
    n = 2 * block
    F = spectral_nbins(n)
    st = ConvolverState(
        queue=_planes(state.queue, "queue", F, n, device, keep_narrow=True),
        prev=_planes(state.prev, "prev", F, n, device, keep_narrow=True),
        step=int(np.asarray(state.step)),
    )
    return _planes(H, "H", F, n, device), st


def matrix_state_from_jax(H, state, *, block: int, device):
    """As :func:`block_state_from_jax` for a ``MatrixConvolver``: ``H [2,
    P, C_in, C_out, F]`` comes back as the port's complex ``[F, P, C_in,
    C_out]``."""
    H, st = block_state_from_jax(H, state, block=block, device=device)
    return filter_from_planes(H), st


def modal_from_jax(leaves, *, device):
    """A ``ModalParams`` (fields ``b0`` .. ``p2i``) or ``ModalState``
    (``x1`` .. ``wi``) of numpy arrays as the port's tuple on ``device``,
    narrow leaves in their dtype."""
    cls = ModalParams if hasattr(leaves, "b0") else ModalState
    return cls(*(_leaf(getattr(leaves, f), device) for f in cls._fields))


def meter_state_from_jax(state, *, device) -> MeterState:
    """A ``LoudnessMeter``'s ``MeterState`` of numpy arrays as the port's
    on ``device``; assign it to the port meter's ``state``."""

    def counts(a):
        return torch.from_numpy(np.array(a, np.int32)).to(device)

    return MeterState(
        shelf=modal_from_jax(state.shelf, device=device),
        rlb=modal_from_jax(state.rlb, device=device),
        sq_tail=_leaf(state.sq_tail, device),
        hist_count=counts(state.hist_count),
        hist_sum=_tensor(state.hist_sum, device),
        momentary_z=_tensor(state.momentary_z, device),
        short_ring=_tensor(state.short_ring, device),
        st_count=counts(state.st_count),
        st_sum=_tensor(state.st_sum, device),
        nblocks=int(np.asarray(state.nblocks)),
    )


def binaural_state_from_jax(H, state, *, block: int, device):
    """``(H, BinauralState)`` of a ``BinauralRenderer`` as tensors on
    ``device``: ``state`` has ``eq`` (one ``ModalState`` per stage) and
    ``conv`` (a ``ConvolverState``) with numpy leaves."""
    H, conv = matrix_state_from_jax(H, state.conv, block=block, device=device)
    eq = tuple(modal_from_jax(s, device=device) for s in state.eq)
    return H, BinauralState(eq=eq, conv=conv)


def ring_from_jax(ring, *, device) -> Ring:
    """A ``Ring`` (``data [..., L]``, ``writepos``) of numpy leaves as the
    port's on ``device``, the write position as a host integer; narrow
    data keeps its dtype."""
    return Ring(_leaf(ring.data, device), int(np.asarray(ring.writepos)))


def eq_delay_state_from_jax(state, *, device) -> EQDelayState:
    """An ``EQDelayPipeline``'s ``EQDelayState`` of numpy leaves as the
    port's on ``device``: ``eq`` is the parallel form's state (``sr``, ``si
    [K, C]``) or one ``ModalState`` a stage, ``ring`` the delay's ring.
    Assign it to the port pipeline's ``state``."""
    if hasattr(state.eq, "sr"):
        eq = ParallelCascadeState(_leaf(state.eq.sr, device),
                                  _leaf(state.eq.si, device))
    else:
        eq = tuple(modal_from_jax(s, device=device) for s in state.eq)
    return EQDelayState(eq=eq, ring=ring_from_jax(state.ring, device=device))


def to_numpy(tree):
    """The port's state with every tensor as a numpy array of its own,
    tuples and named tuples rebuilt around them; integers stay integers.
    A CPU tensor is copied: an engine may later write its buffer."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    if isinstance(tree, tuple):
        leaves = [to_numpy(t) for t in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def bank_state_from_jax(state, *, device) -> BankState:
    """A ``BankState`` of numpy leaves as the port's on ``device``: the JAX
    package's pairs of float32 planes (``targets`` + ``targets_lo``,
    ``origins`` + ``origins_lo``) summed into float64."""

    def f64(hi, lo):
        return torch.from_numpy(np.asarray(hi, np.float64)
                                + np.asarray(lo, np.float64)).to(device)

    return BankState(targets=f64(state.targets, state.targets_lo),
                     origins=f64(state.origins, state.origins_lo),
                     mul=_tensor(state.mul, device),
                     dec=_tensor(state.dec, device),
                     w=_tensor(state.w, device))


def bank_state_to_jax(state: BankState) -> dict:
    """The port's ``BankState`` as the JAX package's seven numpy leaves by
    field name, in its field order: each float64 array ``a`` as the pair
    ``hi = float32(a)``, ``lo = float32(a - hi)``."""

    def split(a):
        a = a.detach().cpu().numpy()
        hi = a.astype(np.float32)
        return hi, (a - hi).astype(np.float32)

    (t_hi, t_lo), (o_hi, o_lo) = split(state.targets), split(state.origins)
    return {"targets": t_hi, "origins": o_hi, "mul": to_numpy(state.mul),
            "dec": to_numpy(state.dec), "w": to_numpy(state.w),
            "targets_lo": t_lo, "origins_lo": o_lo}


def delay_buffer_from_jax(ring, readpos=None, *, device):
    """A ``SoundDelayBuffer`` from the JAX one's ``ring`` (``data [C, L]``,
    ``writepos``), or with ``readpos`` a ``SoundRingBuffer``, continuing
    on ``device`` where the JAX object stopped."""
    data = np.asarray(ring.data)
    if readpos is None:
        buf = SoundDelayBuffer(data.shape[0], data.shape[-1], device=device)
    else:
        buf = SoundRingBuffer(data.shape[0], data.shape[-1], device=device)
        buf.readpos = int(readpos)
    buf.ring = ring_from_jax(ring, device=device)
    return buf


def multilayer_from_jax(data, positions, base, *,
                        device) -> MultilayerBuffer:
    """A ``MultilayerBuffer`` from the JAX one's ring ``data [C, cap]``,
    layer cursors ``positions`` and front ``base``."""
    data = np.asarray(data)
    buf = MultilayerBuffer(len(positions), data.shape[0], data.shape[-1],
                           device=device)
    buf.data = _tensor(data, device)
    buf.positions = np.array(positions, np.int64)
    buf.base = int(base)
    return buf


def running_average_state_from_jax(state, *, device) -> RunningAverageState:
    """A ``RunningAverageState`` (``tail``, ``count``) of numpy leaves as
    the port's on ``device``, the count as a host integer."""
    return RunningAverageState(_tensor(state.tail, device),
                               int(np.asarray(state.count)))


def histogram_state_from_jax(state, *, device) -> HistogramState:
    """A ``HistogramState`` (int32 ``count``, float32 ``sum``) of numpy
    leaves as the port's on ``device``."""
    return HistogramState(
        torch.from_numpy(np.array(state.count, np.int32)).to(device),
        _tensor(state.sum, device))


def interpolator_from_jax(it, *, device) -> Interpolator:
    """An ``Interpolator`` (``current``, ``target``) of numpy leaves."""
    return Interpolator(_tensor(it.current, device), _tensor(it.target, device))


def complex_interpolator_from_jax(ci, *, device) -> ComplexInterpolator:
    """A ``ComplexInterpolator`` (``controller``, ``targets``, ``diffs``)
    of numpy leaves."""
    return ComplexInterpolator(*(_tensor(getattr(ci, f), device)
                                 for f in ComplexInterpolator._fields))
