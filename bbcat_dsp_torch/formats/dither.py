"""Dither before a narrowing integer write, on the host.

The counterpart of the JAX package's ``formats/dither.py``: the same
numpy random streams, so a ditherer made with the same seed gives the same
bits in both packages.  Dither is added to the MSB-aligned 32-bit integer
register just before the write that drops its low ``bits``.
"""

from __future__ import annotations

import numpy as np

from ..utils import native

__all__ = ["Ditherer", "TPDFDitherer", "ShapedDitherer"]


class Ditherer:
    """No dither: the hook's base, which returns its input."""

    def dither(self, channel: int, data: int, bits: int) -> int:
        return data

    def dither_block(self, data: np.ndarray, bits: int,
                     channels: np.ndarray | None = None) -> np.ndarray:
        return data


class TPDFDitherer(Ditherer):
    """Triangular-PDF dither: the sum of two uniform integers over one LSB
    of the target width, less half an LSB, which unbiases the floor of the
    narrowing shift."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def dither_block(self, data: np.ndarray, bits: int,
                     channels: np.ndarray | None = None) -> np.ndarray:
        if bits <= 0:
            return data
        lsb = np.int64(1) << bits
        r = self._rng.integers(0, lsb, size=data.shape, dtype=np.int64)
        r += self._rng.integers(0, lsb, size=data.shape, dtype=np.int64)
        v = data.astype(np.int64) + (r - (lsb >> 1))
        return np.clip(v, -(2**31), 2**31 - 1).astype(np.int32)

    def dither(self, channel: int, data: int, bits: int) -> int:
        return int(self.dither_block(np.array([data], np.int32), bits)[0])


class ShapedDitherer(Ditherer):
    """Error-feedback (noise-shaped) TPDF dither, one error history per
    channel.

    The quantiser's input is the sample less the FIR ``shape`` over past
    quantisation errors, ``w[n] = x[n] - sum_k h[k] e[n-k]`` with ``e[n] =
    q(w[n] + r[n]) - w[n]``, which shapes the output noise by ``1 - H(z)``
    (the default ``h = [1]`` is a 6 dB/octave high-pass).  The history is
    carried across calls, so a stream in blocks equals one whole call.  The
    recurrence runs in the native engine where it is built and in a Python
    loop otherwise, on the same random stream: the two agree bit for bit.
    """

    def __init__(self, shape: tuple[float, ...] = (1.0,), seed: int = 0):
        self._h = np.asarray(shape, np.float64)
        self._rng = np.random.default_rng(seed)
        self._ehist: np.ndarray | None = None  # [order, nch], newest first

    def reset(self) -> None:
        self._ehist = None

    def _ensure(self, nch: int) -> np.ndarray:
        if self._ehist is None or self._ehist.shape[1] < nch:
            eh = np.zeros((len(self._h), nch))
            if self._ehist is not None:
                eh[:, :self._ehist.shape[1]] = self._ehist
            self._ehist = eh
        return self._ehist[:, :nch]

    def dither_block(self, data: np.ndarray, bits: int,
                     channels: np.ndarray | None = None) -> np.ndarray:
        if bits <= 0:
            return data
        lsb = float(1 << bits)
        nch = 1 if channels is None else int(np.max(channels)) + 1
        # the transfer tiles channels frame-major, so the flat block is
        # [nframes, nch]
        d2 = np.asarray(data, np.float64).reshape(-1, nch)
        eh = self._ensure(nch)
        # both TPDF components drawn per sample (last axis): the stream is
        # the same whether the signal comes in one call or in blocks
        r = self._rng.integers(0, 1 << bits, size=(*d2.shape, 2)).sum(-1)
        r = r.astype(np.float64) - (1 << (bits - 1))

        eh_c = np.ascontiguousarray(eh)
        out = native.shaped_dither_block(
            d2.astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32),
            r, eh_c, self._h, bits)
        if out is not None:
            self._ehist[:, :nch] = eh_c
            return out.reshape(np.asarray(data).shape)

        out = np.empty_like(d2)
        for n in range(d2.shape[0]):
            w = d2[n] - self._h @ eh
            v = np.rint(w + r[n])
            # the write truncates with (v >> bits) << bits, a floor
            q = np.floor(v / lsb) * lsb
            eh[1:] = eh[:-1]
            eh[0] = q - w
            out[n] = v
        self._ehist[:, :nch] = eh
        return np.clip(out.reshape(np.asarray(data).shape), -(2.0**31),
                       2.0**31 - 1).astype(np.int32)

    def dither(self, channel: int, data: int, bits: int) -> int:
        """One sample, updating only ``channel``'s history."""
        if bits <= 0:
            return data
        lsb = float(1 << bits)
        eh = self._ensure(channel + 1)
        w = float(data) - float(self._h @ eh[:, channel])
        r = float(self._rng.integers(0, 1 << bits, size=2).sum()
                  - (1 << (bits - 1)))
        v = float(np.rint(w + r))
        q = np.floor(v / lsb) * lsb
        eh[1:, channel] = eh[:-1, channel]
        eh[0, channel] = q - w
        return int(np.clip(v, -(2.0**31), 2.0**31 - 1))
