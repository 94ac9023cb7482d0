"""Offline convolution (a bounce to disk, a batch render): overlap-save
with one large transform a chunk: the counterpart of the JAX package's
``convolve/offline.py``.

Where no block latency is asked for, a few passes over the signal with
large transforms do what the partitioned engines do block by block.  The
JAX package runs these transforms in XLA, not in Pallas, so ``torch.fft``
is their counterpart here.  The IR's spectrum comes from a float64
transform; the signal's transforms are float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["offline_convolve"]


def offline_convolve(x: torch.Tensor, ir, n_fft: int | None = None
                     ) -> torch.Tensor:
    """Convolve ``x [C, T]`` (or ``[T]``) with ``ir [C, N]`` (or ``[N]``,
    one IR for every channel), on ``x``'s device: the first ``T`` output
    samples, aligned as the streaming engines align theirs.

    ``n_fft`` is by default the least power of two >= ``max(8 N, 2048)``,
    so the overlap of ``N - 1`` samples is about an eighth of a transform;
    it must be at least ``2 N``."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    ir2 = np.atleast_2d(np.asarray(ir, np.float64))
    C, T = x.shape
    if ir2.shape[0] == 1 and C > 1:
        ir2 = np.broadcast_to(ir2, (C, ir2.shape[1]))
    N = ir2.shape[1]
    if n_fft is None:
        n_fft = 1 << int(np.ceil(np.log2(max(8 * N, 2048))))
    if n_fft < 2 * N:
        raise ValueError(f"n_fft={n_fft} too small for {N}-tap IR")
    hop = n_fft - N + 1
    # the IRs' spectrum from a float64 transform, rounded once; on x's
    # device (at 64 x 32768 taps the host's takes a third of a second)
    H = torch.fft.rfft(torch.from_numpy(np.ascontiguousarray(ir2)).to(
        x.device), n=n_fft).to(torch.complex64)

    nchunks = -(-T // hop)
    # N - 1 samples of silence before (the overlap-save history), and
    # silence after up to the last chunk's end
    xpad = F.pad(x, (N - 1, (nchunks - 1) * hop + n_fft - (N - 1) - T))
    ys = []
    for i in range(nchunks):
        spec = torch.fft.rfft(xpad[:, i * hop:i * hop + n_fft], n=n_fft)
        ys.append(torch.fft.irfft(spec * H, n=n_fft)[:, n_fft - hop:])
    y = torch.cat(ys, -1)[:, :T]
    return y[0] if squeeze else y
