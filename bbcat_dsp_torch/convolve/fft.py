"""Half-window spectral transforms, standard (natural bin order) layout.

The PyTorch counterpart of the standard-layout subset of
the JAX package's ``convolve/fft.py``.  Spectra are re/im PLANE tensors
``[2, ..., F]`` float32 at every public function, so the port and the JAX
package compare like with like; ``torch.fft`` works on complex tensors
inside.  On a CUDA tensor the engine takes these transforms through its
own kernels (``ops_hook.rfft_half`` and ``ops_hook.irfft_tail``); the
functions here are their plain versions.

Overlap-save at FFT size ``n`` transforms only the ``n/2`` NEW samples of a
block (the upper half of the window is zero), and the full window spectrum
assembles by the shift theorem as ``X_window = Xhalf_prev + (-1)^k
Xhalf_cur``.  The inverse keeps only the last ``n/2`` output samples, all
that overlap-save ever uses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "SpectralSpec",
    "spectral_nbins",
    "half_window_signs",
    "rfft_planes",
    "rfft_half_planes",
    "irfft_planes",
    "irfft_tail_planes",
    "cmul",
    "planes_from_complex",
]


class SpectralSpec(NamedTuple):
    """Frozen spectral configuration of one half-window engine level.

    The port serves the standard layout only; a permuted-layout spectrum
    (``r * (n/r/2 + 1)`` bins) from the JAX package does not fit it and
    is refused where state crosses over (``utils.interop``)."""

    n: int               # FFT size (2 * the level's block)
    layout: str = "std"


def spectral_nbins(n: int) -> int:
    """Bins a standard-layout half-window spectrum of FFT size ``n`` holds."""
    return n // 2 + 1


def half_window_signs(n: int, device) -> torch.Tensor:
    """The ``(-1)^k`` second-half shift signs over the ``n//2 + 1`` bins."""
    s = torch.ones(n // 2 + 1, dtype=torch.float32, device=device)
    s[1::2] = -1.0
    return s


def rfft_planes(x: torch.Tensor, n: int) -> torch.Tensor:
    """Real FFT of the last axis at size ``n`` (zero-padded to it) ->
    ``[2, ..., n//2 + 1]`` re/im planes."""
    X = torch.fft.rfft(x, n=n, dim=-1)
    return torch.stack([X.real, X.imag])


def rfft_half_planes(x: torch.Tensor, n: int) -> torch.Tensor:
    """rFFT of ``[x, zeros]`` where ``x.shape[-1] == n // 2`` ->
    ``[2, ..., n//2 + 1]`` planes."""
    return rfft_planes(x, n)


def _real_spectrum(planes: torch.Tensor, n: int) -> torch.Tensor:
    """Re/im planes ``[2, ..., F]`` as the complex spectrum of a real
    ``n``-point signal: the imaginary parts of the DC bin and, for an even
    ``n`` whose Nyquist bin is among the ``F``, of that bin dropped, as
    the inverse of a real transform defines them.  pocketfft and
    ``jnp.fft`` ignore them, but cuFFT's C2R leaves its output undefined
    unless they are zero."""
    im = planes[1].clone()
    im[..., 0] = 0.0
    if n % 2 == 0 and planes.shape[-1] > n // 2:
        im[..., n // 2] = 0.0
    return torch.complex(planes[0], im)


def irfft_planes(planes: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse rFFT of ``[2, ..., F]`` planes -> ``n`` real samples on the
    last axis; the bins past ``n // 2`` are ignored and missing ones are
    zero, as in ``torch.fft.irfft``."""
    return torch.fft.irfft(_real_spectrum(planes, n), n=n, dim=-1)


def irfft_tail_planes(spec_planes: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse rFFT of ``[2, ..., n//2 + 1]`` planes, returning only the
    last ``n // 2`` samples (DC and Nyquist as :func:`irfft_planes` takes
    them)."""
    return irfft_planes(spec_planes, n)[..., n // 2:]


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complex product of two plane tensors ``[2, ...]``."""
    return torch.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def planes_from_complex(z, dtype=torch.float32, *, device) -> torch.Tensor:
    """A host (complex) array ``z`` as re/im planes ``[2, ...]`` of
    ``dtype`` on ``device``."""
    z = np.asarray(z)
    return torch.from_numpy(np.stack([z.real, z.imag])).to(device=device,
                                                            dtype=dtype)
