"""ctypes bindings to the native (C++) host-side format conversion engine.

The counterpart of the JAX package's ``utils/native.py``, over the same
source, ``native/src/formatconv.cpp`` at the root of the checkout.  At its
first use in a process it is built with the host's C++ compiler into
``bbcat_dsp_torch/_build/native/``, under a name keyed by the source's
hash, and later processes of the same checkout reuse it.  A build is
written to a temporary file and renamed into place, so processes that
build at once never load a partial library.  Without a compiler (or
without the source) every caller falls back to its numpy path, which
gives the same bytes; :func:`status` says which path serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "native_available", "status", "transfer_rect",
           "transfer_rect_path", "shaped_dither_block"]

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR.parent / "native" / "src" / "formatconv.cpp"
_BUILD_DIR = _PKG_DIR / "_build" / "native"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_STATUS: dict | None = None

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _build() -> tuple[Path, float | None]:
    """The library's path and the seconds its build took here (None when
    an earlier process built it)."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes())
    so = _BUILD_DIR / f"libbbcat_formatconv_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None where it cannot be built."""
    global _LIB, _STATUS
    with _LOCK:
        if _STATUS is not None:
            return _LIB
        _STATUS = {"available": False, "path": None, "build_seconds": None,
                   "error": None}
        if not _SRC.exists():
            _STATUS["error"] = f"no source at {_SRC}"
            return None
        try:
            so, secs = _build()
        except (OSError, subprocess.SubprocessError) as e:
            _STATUS["error"] = f"build failed: {e}"
            return None
        lib = ctypes.CDLL(str(so))
        lib.fc_transfer.restype = ctypes.c_int
        lib.fc_transfer.argtypes = [_P, _I32, _I32, _I64, _I64,
                                    _P, _I32, _I32, _I64, _I64, _I64, _I64]
        lib.fc_version.restype = ctypes.c_int
        lib.fc_version.argtypes = []
        lib.fc_shaped_dither.restype = None
        lib.fc_shaped_dither.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64,
                                         _I32, _P]
        _STATUS.update(available=True, path=str(so), build_seconds=secs)
        _LIB = lib
        return lib


def native_available() -> bool:
    return get_lib() is not None


def status() -> dict:
    """``{"available", "path", "build_seconds", "error"}``: whether the
    engine serves, where its library is, how long this process took to
    build it (None when it was built already) and why it is missing."""
    get_lib()
    return dict(_STATUS)


def _check_buffer(a: np.ndarray, name: str) -> None:
    if a.dtype != np.uint8 or not a.flags.c_contiguous:
        raise ValueError(f"{name}: a contiguous uint8 buffer is needed, got "
                         f"{a.dtype}, contiguous={a.flags.c_contiguous}")


def transfer_rect(
    src: np.ndarray, src_fmt: int, src_be: bool, src_channel: int,
    src_channels: int, dst: np.ndarray, dst_fmt: int, dst_be: bool,
    dst_channel: int, dst_channels: int, nchannels: int, nframes: int,
) -> bool:
    """Native rectangle transfer between uint8 buffers; False where the
    engine is not available."""
    return transfer_rect_path(
        src, src_fmt, src_be, src_channel, src_channels,
        dst, dst_fmt, dst_be, dst_channel, dst_channels,
        nchannels, nframes) >= 0


def transfer_rect_path(
    src: np.ndarray, src_fmt: int, src_be: bool, src_channel: int,
    src_channels: int, dst: np.ndarray, dst_fmt: int, dst_be: bool,
    dst_channel: int, dst_channels: int, nchannels: int, nframes: int,
) -> int:
    """As :func:`transfer_rect`, returning the engine's path: 0 the
    converting loop, 1 a copy a frame, 2 one bulk copy; -1 where the
    engine is not available or a format is unknown."""
    lib = get_lib()
    if lib is None:
        return -1
    _check_buffer(src, "src")
    _check_buffer(dst, "dst")
    return lib.fc_transfer(
        src.ctypes.data, int(src_fmt), int(src_be), src_channel,
        src_channels, dst.ctypes.data, int(dst_fmt), int(dst_be),
        dst_channel, dst_channels, nchannels, nframes)


def shaped_dither_block(
    data: np.ndarray, r: np.ndarray, ehist: np.ndarray, h: np.ndarray,
    bits: int,
) -> np.ndarray | None:
    """The error-feedback dither over ``data [nfr, nch]`` (MSB-aligned
    int32) with centred TPDF randoms ``r [nfr, nch]`` (float64), the error
    history ``ehist [order, nch]`` (float64, updated in place) and the
    feedback FIR ``h [order]``: the dithered int32 block, or None where the
    engine is not available."""
    lib = get_lib()
    if lib is None:
        return None
    nfr, nch = data.shape
    if ehist.dtype != np.float64 or not ehist.flags.c_contiguous:
        raise ValueError("ehist: a contiguous float64 array is needed")
    if r.shape != (nfr, nch) or ehist.shape != (len(h), nch):
        raise ValueError(f"shapes: data {data.shape}, r {r.shape}, ehist "
                         f"{ehist.shape}, h {np.shape(h)}")
    data32 = np.ascontiguousarray(data, np.int32)
    r64 = np.ascontiguousarray(r, np.float64)
    h64 = np.ascontiguousarray(h, np.float64)
    out = np.empty((nfr, nch), np.int32)
    lib.fc_shaped_dither(data32.ctypes.data, r64.ctypes.data,
                         ehist.ctypes.data, h64.ctypes.data, ehist.shape[0],
                         nfr, nch, int(bits), out.ctypes.data)
    return out
