"""Build the package's CUDA kernels with ``nvcc`` and bind them with ctypes.

Every ``csrc/*.cu`` file compiles, one ``nvcc`` per file and all of them
at once, into an object that one link joins into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), for
``sm_90a`` (Hopper).  The library lands in ``bbcat_dsp_torch/_build/``
under a name keyed by the sources' and flags' hash, is built at the first
CUDA use in a process and reused by later processes of the same checkout.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
The launch counters live here too: a wrapper adds one to its kernel's
count right after a launch succeeds, and a plain version adds one to its
own count each time it runs (:func:`count_plain`): to ``PLAIN_CALLS``, or
to ``ADJOINT_CALLS`` when it runs as the adjoint of a backward pass
(inside :func:`adjoint`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["library", "check", "require", "require_cuda", "stream_of",
           "count_plain", "adjoint", "LAUNCHES", "PLAIN_CALLS",
           "ADJOINT_CALLS"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# K9 counts apart by the queue's type: its float32, bfloat16 and float16
# instantiations
KERNELS = ("fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
           "gather_supers", "delayed_add", "head_mac", "rotated_mac",
           "rotated_mac_bf16", "rotated_mac_f16", "xt_step_mac")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)
ADJOINT_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)
# per thread: a CUDA backward pass runs in autograd's own thread
_COUNTING = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers, ints, then the stream)
_SIGNATURES = {
    "bbcat_fused_head": [_P] * 9 + [_I] * 5 + [_P],
    "bbcat_rfft_half": [_P] * 3 + [_I] * 2 + [_P],
    "bbcat_irfft_tail": [_P] * 3 + [_I] * 2 + [_P],
    "bbcat_xt_grouped_mac": [_P] * 4 + [_I] * 4 + [_P],
    "bbcat_gather_supers": [_P] * 2 + [_I] * 3 + [_P],
    "bbcat_delayed_add": [_P] * 4 + [_I] * 3 + [_P],
    "bbcat_head_mac": [_P] * 3 + [_I] * 5 + [_P],
    "bbcat_rotated_mac": [_P] * 3 + [_I] * 5 + [_P],
    "bbcat_xt_step_mac": [_P] * 4 + [_I] * 6 + [_P],
    "bbcat_half_fft_plan": [_I, _P, _P, _I, _P, _P],
    "bbcat_xt_unrolled_parts": [],
    "bbcat_rotated_mac_schedule": [_I],
}

_LIB: ctypes.CDLL | None = None
BUILD_LOG: str = ""
BUILD_SECONDS: float | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(tmp: Path, so: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``so``; returns the compilers' output."""
    nvcc = _nvcc()
    procs = []
    try:
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [proc.communicate()[0] for _, _, proc in procs]
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = "".join(logs)
    failed = [src.name for src, _, proc in procs if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    lib = tmp / so.name
    res = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    os.replace(lib, so)
    return log


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a; this card is sm_{major}{minor}")
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"libbbcat_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    if not so.exists():
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            BUILD_LOG = _compile(Path(tmp), so)
    BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bbcat_error_string.argtypes = [ctypes.c_int]
    lib.bbcat_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().bbcat_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def count_plain(name: str) -> None:
    """One run of kernel ``name``'s plain version: an adjoint's inside
    :func:`adjoint`, a plain call anywhere else."""
    adj = getattr(_COUNTING, "adjoint", False)
    (ADJOINT_CALLS if adj else PLAIN_CALLS)[name] += 1


@contextlib.contextmanager
def adjoint():
    """Count the plain versions run in this block, on this thread, as the
    adjoints of a backward pass."""
    _COUNTING.adjoint = True
    try:
        yield
    finally:
        _COUNTING.adjoint = False


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape: tuple,
            dtypes: tuple = (torch.float32,)) -> None:
    """Check what every kernel operand must be: of one of ``dtypes``
    (float32 unless the kernel says otherwise), contiguous, of the given
    shape."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        want = " or ".join(map(str, dtypes))
        raise ValueError(f"{name}: dtype {t.dtype}, expected {want}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_cuda(**tensors: torch.Tensor) -> torch.device:
    """Check that all operands lie on one CUDA device; return it."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        where = ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        raise ValueError(f"the kernel needs its operands on one CUDA "
                         f"device: {where}")
    return devs.pop()
