"""State files that both packages read: ``save_state`` and ``load_state``
in the JAX package's checkpoint format 4.

A file is a pickle of ``{"treedef", "leaves", "meta"}``: the state's
arrays as numpy, in the order of its named tuples' fields.  The port
writes the leaves in the JAX package's shapes and dtypes (spectra as re/im
planes, counters such as ``tail.step`` and ``writepos`` as int32 arrays, a
``BankState`` as its seven float32 leaves), ``treedef: None`` (the JAX
package's ``load_state(path, like=...)`` never reads the stored one) and
the ``meta`` of a standard-layout format-4 writer, so the JAX package
loads it as its own.

A file the JAX package wrote holds a JAX tree definition and that
package's classes.  It is read here through an unpickler that admits
numpy's classes and puts an inert stand-in for every other: only
``leaves`` and ``meta`` are used, neither JAX nor the JAX package is
imported, and a file can construct nothing but numpy arrays and plain
containers.  The leaves then fill the port's state ``like`` in order.
Spectra written in the permuted layout (``r (n / 2r + 1)`` bins: 4104
against 4097 at n = 8192) are brought into the standard one; the
layout's extra bins are conjugate mirrors and are dropped.

A bfloat16 or float16 queue (a block or matrix convolver built with that
``dtype``) crosses bit for bit and keeps its dtype both ways, as the JAX
package's ``load_state`` keeps a file's: float16 as numpy's, bfloat16 as
an ``ml_dtypes`` array, which is the JAX package's own.  Where
``ml_dtypes`` does not import, a bfloat16 state is neither written nor
read: the error names the package.

States that cross: the two-level convolver's, the block and matrix
convolvers', the modal engine's, the meter's, the binaural renderer's, a
ring, an ``EQDelayState``, a ``BankState``, and tuples, lists and dicts of
these.

What a state does not hold in either package, and a file therefore loses:
the small-block path's partly filled super-block (``_sb_buf``,
``_sb_fill``), its count of tail steps and a scheduled IR exchange (save at
a super-block boundary, with no exchange pending); the filters themselves
(build the engine with the same IRs first); a bank's count of remaining
ramp samples and, on steady blocks, its modal engine's state (use
``BiQuadFilterBank.snapshot`` and ``restore``).
"""

from __future__ import annotations

import os
import pickle
from types import SimpleNamespace

import numpy as np
import torch

from ..filters.bank import BankState
from .interop import bank_state_from_jax, bank_state_to_jax, narrow_tensor

__all__ = ["save_state", "load_state"]

_FORMAT = 4
# the permuted layout is never made at or below this transform size, and
# only with these radices
_PERM_MIN_N = 2048
_PERM_RADICES = (8, 16, 32, 4)
_NARROW = (torch.bfloat16, torch.float16)


def _ml_dtypes():
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "a bfloat16 state is stored as the JAX package stores it, an "
            "ml_dtypes array, and this needs the ml_dtypes package, which "
            "does not import here") from e
    return ml_dtypes


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_ml_dtypes().bfloat16)
    return t.numpy()


def _flatten(state, out: list) -> None:
    """The leaves of ``state`` in the JAX package's order, shapes and
    dtypes, appended to ``out``."""
    if isinstance(state, BankState):
        out.extend(bank_state_to_jax(state).values())
    elif isinstance(state, torch.Tensor):
        out.append(_numpy_of(state))
    elif isinstance(state, (bool, int, np.integer)):
        out.append(np.asarray(state, np.int32))
    elif isinstance(state, dict):
        for key in sorted(state):
            _flatten(state[key], out)
    elif isinstance(state, (tuple, list)):
        for item in state:
            _flatten(item, out)
    elif state is not None:
        raise TypeError(f"no leaf of a state: {type(state).__name__}")


def save_state(path: str, state) -> None:
    """Write ``state`` (the port's state tuples, tensors on any device) to
    ``path`` as a format-4 file."""
    leaves: list = []
    _flatten(state, leaves)
    meta = {"format": _FORMAT, "writer": "bbcat_dsp_torch",
            "fft_backend": "torch", "layout": "std",
            "perm_layout_env": "0", "perm_radix_env": "8", "perm_order": 2}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump({"treedef": None, "leaves": leaves, "meta": meta}, fp)


class _Inert:
    """Stands in for every class and function of a pickle that is not
    numpy's: built from, called with and set to anything, it does
    nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return _Inert()

    def __setstate__(self, state):
        pass


class _LeavesUnpickler(pickle.Unpickler):
    """Loads numpy arrays and plain containers; whatever else the file
    names (a JAX tree definition, the JAX package's named tuples) becomes
    :class:`_Inert` and is never imported."""

    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _ml_dtypes().bfloat16
        return _Inert


def _unpermute(planes: np.ndarray, nbins: int):
    """Re/im planes ``[2, ..., F]`` in the permuted layout as ``[2, ...,
    nbins]`` in the standard one, or ``None`` where ``F`` is the permuted
    bin count of no radix at ``n = 2 (nbins - 1)``.

    Bin ``k = r k1 + k2`` of an ``n``-point half spectrum sits at ``k2 h +
    k1`` for ``k1 < h = n / 2r``, and at ``r h + k2`` for ``k1 = h``."""
    n = 2 * (nbins - 1)
    if n <= _PERM_MIN_N or planes.ndim < 2 or planes.shape[0] != 2:
        return None
    for r in _PERM_RADICES:
        h = n // r // 2
        if n % (2 * r) == 0 and planes.shape[-1] == r * (h + 1):
            k = np.arange(nbins)
            k1, k2 = k // r, k % r
            return planes[..., np.where(k1 < h, k2 * h + k1, r * h + k2)]
    return None


def _fill(like, leaves: list, at: list):
    """``like`` rebuilt around the next leaves of the file."""
    if isinstance(like, BankState):
        got = leaves[at[0]:at[0] + 7]
        at[0] += 7
        if len(got) < 7:
            raise ValueError("the file ends inside a BankState")
        jax_fields = ("targets", "origins", "mul", "dec", "w", "targets_lo",
                      "origins_lo")
        st = bank_state_from_jax(SimpleNamespace(**dict(zip(jax_fields, got))),
                                 device=like.w.device)
        for name, want, have in zip(like._fields, like, st):
            if want.shape != have.shape:
                raise ValueError(f"BankState.{name}: shape "
                                 f"{tuple(have.shape)} in the file, expected "
                                 f"{tuple(want.shape)}")
        return st._replace(w=st.w.to(like.w.dtype))
    if isinstance(like, dict):
        return {key: _fill(like[key], leaves, at) for key in sorted(like)}
    if isinstance(like, (tuple, list)):
        items = [_fill(item, leaves, at) for item in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    if like is None:
        return None
    if at[0] >= len(leaves):
        raise ValueError(f"the file holds {len(leaves)} leaves, fewer than "
                         "the state has: another state's file?")
    got = np.asarray(leaves[at[0]])
    at[0] += 1
    if isinstance(like, torch.Tensor):
        if got.shape != tuple(like.shape):
            conv = _unpermute(got, like.shape[-1]) if like.dim() else None
            if conv is None or conv.shape != tuple(like.shape):
                raise ValueError(
                    f"leaf {at[0] - 1}: shape {got.shape} in the file, "
                    f"expected {tuple(like.shape)} (and no permuted spectral "
                    "layout of it)")
            got = conv
        # a narrow leaf, or one that a narrow engine's state expects (its
        # prev is float32 once a block has run), keeps the file's dtype
        t = narrow_tensor(got)
        if t is None:
            t = torch.from_numpy(np.array(got, order="C"))
            if like.dtype not in _NARROW:
                t = t.to(like.dtype)
        return t.to(like.device)
    if got.shape != ():
        raise ValueError(f"leaf {at[0] - 1}: shape {got.shape} in the file, "
                         "expected a counter")
    return int(got)


def load_state(path: str, like):
    """The state in ``path``, in the structure, dtypes and devices of
    ``like`` (the state of a freshly built engine; a bfloat16 or float16
    leaf, or a leaf where ``like`` has one, keeps the file's dtype): a
    file of the port's
    :func:`save_state` or of the JAX package's.  Format 4 only; an older
    file is refused by its format number (load and save it again with the
    JAX package, which migrates formats 1 to 3)."""
    with open(path, "rb") as fp:
        blob = _LeavesUnpickler(fp).load()
    meta = blob.get("meta") or {}
    fmt = meta.get("format", 1)
    if fmt != _FORMAT:
        raise ValueError(f"{path}: checkpoint format {fmt}; this reader "
                         f"takes format {_FORMAT} only")
    if meta.get("perm_order", 1) != 2:
        raise ValueError(f"{path}: permuted bin order "
                         f"{meta.get('perm_order', 1)}; this reader takes "
                         "order 2 only")
    leaves, at = list(blob["leaves"]), [0]
    state = _fill(like, leaves, at)
    if at[0] != len(leaves):
        raise ValueError(f"{path} holds {len(leaves)} leaves, the state "
                         f"{at[0]}: another state's file?")
    return state
