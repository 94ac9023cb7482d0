"""The rest of the JAX package's public surface in the port: the ``utils``
re-exports and their import order, ``filters.write_response``, and
``convolve.irfft_planes`` / ``cmul`` / ``planes_from_complex``, each
against the JAX package on the same numpy inputs.

``irfft_planes`` is held at >= 110 dB against JAX's ``backend="xla"``
(both are pocketfft on the CPU, so they read far above it); ``cmul`` is
exact (the same four products and two sums in float32); the response file
is the same bytes.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import convolve as jconvolve
from bbcat_dsp_tpu import filters as jfilters
from bbcat_dsp_tpu.convolve.fft import planes_from_complex as jplanes
from bbcat_dsp_torch import convolve, filters, utils
from bbcat_dsp_torch.convolve.fft import planes_from_complex
from conftest import snr_db

ROOT = Path(__file__).resolve().parent.parent
FS = 48000.0


# ---- utils ------------------------------------------------------------------------

def test_utils_exports_the_jax_packages_names():
    from bbcat_dsp_torch.utils import (  # noqa: F401
        Timer,
        load_state,
        named_scope,
        native,
        native_available,
        save_state,
        trace,
    )
    from bbcat_dsp_torch.utils import checkpoint, native as native_mod
    from bbcat_dsp_torch.utils import profiling
    import bbcat_dsp_tpu.utils as jutils

    assert sorted(utils.__all__) == sorted(jutils.__all__)
    assert native is native_mod
    assert native_available is native_mod.native_available
    assert (Timer, named_scope, trace) == (profiling.Timer,
                                           profiling.named_scope,
                                           profiling.trace)
    assert (load_state, save_state) == (checkpoint.load_state,
                                        checkpoint.save_state)
    with pytest.raises(AttributeError):
        utils.no_such_name  # noqa: B018


FIRST_IMPORTS = ["bbcat_dsp_torch.filters.iir", "bbcat_dsp_torch.convolve.matrix",
                 "bbcat_dsp_torch.utils", "bbcat_dsp_torch.utils.checkpoint",
                 "bbcat_dsp_torch.formats.host", "bbcat_dsp_torch.ops.conv2d",
                 "bbcat_dsp_torch.models.pipeline"]

IMPORT_FIRST = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["bbcat_dsp_tpu"] = None
importlib.import_module(sys.argv[1])
from bbcat_dsp_torch.utils import load_state, save_state, Timer, native
from bbcat_dsp_torch.filters import write_response
from bbcat_dsp_torch.convolve import irfft_planes, cmul
print("imported", sys.argv[1])
"""


@pytest.mark.parametrize("first", FIRST_IMPORTS)
def test_any_module_imports_first_without_jax(first):
    """Each module imported first in a fresh process that cannot import
    JAX: no import cycle through ``utils`` leaves a package half
    built."""
    out = subprocess.run([sys.executable, "-c", IMPORT_FIRST, first],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {first}" in out.stdout


# ---- write_response ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"npoints": 37, "fmin": 20.0}])
def test_write_response_is_the_jax_packages_file(tmp_path, kw):
    coeffs = np.stack([filters.biquad_coeffs(filters.FilterType.LPF12, 1000.0,
                                             FS),
                       filters.biquad_coeffs(filters.FilterType.PEQ, 3000.0,
                                             FS, 6.0, 0.5)])
    for c in (coeffs[0], coeffs):
        f = filters.write_response(tmp_path / "port.dat", c, FS, **kw)
        jf = jfilters.write_response(tmp_path / "jax.dat", c, FS, **kw)
        assert (tmp_path / "port.dat").read_bytes() == \
            (tmp_path / "jax.dat").read_bytes()
        np.testing.assert_array_equal(f, jf)
        assert len(f) == kw.get("npoints", 1000)


# ---- irfft_planes, cmul, planes_from_complex ---------------------------------------

@pytest.mark.parametrize("n", [64, 256, 1024, 8192])
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_irfft_planes_matches_jax(rng, n, lead):
    """Random spectra, nonzero imaginary parts at DC and Nyquist
    included: both inverses drop them."""
    planes = rng.standard_normal((2, *lead, n // 2 + 1)).astype(np.float32)
    want = np.asarray(jconvolve.irfft_planes(jnp.asarray(planes), n,
                                             backend="xla"))
    got = convolve.irfft_planes(torch.from_numpy(planes), n)
    assert got.shape == want.shape == (*lead, n)
    assert snr_db(want, got.numpy()) >= 110.0


def test_irfft_planes_ignores_dc_and_nyquist_imaginary_parts(rng):
    n = 256
    planes = rng.standard_normal((2, 4, n // 2 + 1)).astype(np.float32)
    clean = planes.copy()
    clean[1, :, 0] = clean[1, :, -1] = 0.0
    a = convolve.irfft_planes(torch.from_numpy(planes), n)
    b = convolve.irfft_planes(torch.from_numpy(clean), n)
    assert torch.equal(a, b)
    assert not np.any(planes[1, :, [0, -1]] == 0.0)


def test_irfft_planes_round_trips_rfft_planes(rng):
    """The round trip of ``tests/test_convolve.py``'s backend check."""
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    planes = convolve.rfft_planes(torch.from_numpy(x), 1024)
    y = convolve.irfft_planes(planes, 1024).numpy()
    np.testing.assert_allclose(y, x, atol=1e-4)
    want = np.asarray(jconvolve.irfft_planes(
        jconvolve.rfft_planes(jnp.asarray(x), 1024, backend="xla"), 1024,
        backend="xla"))
    assert snr_db(want, y) >= 110.0


@pytest.mark.parametrize("n", [63, 100])
def test_irfft_planes_at_other_bin_counts_and_odd_sizes(rng, n):
    """Fewer or more bins than ``n // 2 + 1`` and an odd ``n``: as
    ``jnp.fft.irfft`` takes them."""
    for F in (n // 2 - 3, n // 2 + 1, n // 2 + 9):
        planes = rng.standard_normal((2, 3, F)).astype(np.float32)
        want = np.asarray(jconvolve.irfft_planes(jnp.asarray(planes), n,
                                                 backend="xla"))
        got = convolve.irfft_planes(torch.from_numpy(planes), n).numpy()
        assert got.shape == want.shape
        assert snr_db(want, got) >= 110.0, F


def test_cmul_is_the_jax_packages(rng):
    a, b = (rng.standard_normal((2, 4, 7, 33)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jconvolve.cmul(jnp.asarray(a), jnp.asarray(b)))
    got = convolve.cmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_planes_from_complex_is_the_jax_packages(rng, dtype):
    z = rng.standard_normal((3, 17)) + 1j * rng.standard_normal((3, 17))
    want = np.asarray(jplanes(z, getattr(jnp, dtype)))
    got = planes_from_complex(z, getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    real = planes_from_complex(z.real, device="cpu")
    assert real.shape == (2, 3, 17) and not real[1].any()
