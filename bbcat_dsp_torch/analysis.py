"""Running averages and histograms.

The counterpart of the JAX package's ``analysis.py``: per-sample updates
become block operations over explicit states.  The running mean is a
float32 ``cumsum`` over the last ``window - 1`` samples and the block, as
there; PyTorch sums in another order than XLA, so the two agree to a
relative ~1e-6, not bit for bit.  A histogram's counts and bins are exact
in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["RunningAverageState", "running_average_init",
           "running_average_update", "RunningAverage", "HistogramState",
           "histogram_init", "histogram_update", "Histogram"]


class RunningAverageState(NamedTuple):
    tail: torch.Tensor  # [..., window - 1]: the samples before the block
    count: int          # samples seen so far (for the partly filled start)


def running_average_init(shape, window: int, dtype=torch.float32, *,
                         device) -> RunningAverageState:
    return RunningAverageState(
        torch.zeros(tuple(shape) + (window - 1,), dtype=dtype, device=device),
        0)


def running_average_update(state: RunningAverageState, x: torch.Tensor,
                           window: int, alt_window: int | None = None):
    """Sliding means of every sample of ``x [..., T]`` over the last
    ``window`` samples: ``(means, state')``, or with ``alt_window`` also
    the means over that shorter window of the same history, ``(means,
    alt_means, state')``.  Until a window has filled, the mean is over the
    samples seen."""
    W, T = window, x.shape[-1]
    ext = torch.cat([state.tail, x.to(state.tail.dtype)], -1)
    cs = torch.cumsum(ext.float(), -1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], -1)
    seen = torch.arange(state.count + 1, state.count + T + 1,
                        device=x.device)

    def win_means(w):
        # sample i of the block is place W - 1 + i of ext; its window
        # covers places W - w + i .. W - 1 + i
        sums = cs[..., W:W + T] - cs[..., W - w:W - w + T]
        return sums / torch.clamp(seen, max=w).to(sums.dtype)

    new_state = RunningAverageState(ext[..., T:], state.count + T)
    if alt_window is not None:
        return win_means(W), win_means(alt_window), new_state
    return win_means(W), new_state


class RunningAverage:
    """A running mean over ``window`` samples (and optionally over
    ``alt_window``) of a stream written in blocks."""

    def __init__(self, window: int, shape=(), alt_window: int | None = None,
                 dtype=torch.float32, *, device):
        self.window = int(window)
        self.alt_window = alt_window
        self.state = running_average_init(shape, self.window, dtype,
                                          device=device)
        self._last = None
        self._last_alt = None

    def write(self, x: torch.Tensor) -> torch.Tensor:
        if self.alt_window is not None:
            m, self._last_alt, self.state = running_average_update(
                self.state, x, self.window, self.alt_window)
        else:
            m, self.state = running_average_update(self.state, x, self.window)
        self._last = m
        return m

    def average(self) -> float:
        return float(self._last[..., -1]) if self._last is not None else 0.0

    def alt_average(self) -> float:
        return (float(self._last_alt[..., -1]) if self._last_alt is not None
                else 0.0)

    def reset(self) -> None:
        tail = self.state.tail
        self.state = running_average_init(tail.shape[:-1], self.window,
                                          tail.dtype, device=tail.device)
        self._last = self._last_alt = None


class HistogramState(NamedTuple):
    count: torch.Tensor  # [nbins] int32
    sum: torch.Tensor    # [nbins] float32


def histogram_init(nbins: int, *, device) -> HistogramState:
    return HistogramState(torch.zeros(nbins, dtype=torch.int32, device=device),
                          torch.zeros(nbins, dtype=torch.float32,
                                      device=device))


def histogram_update(state: HistogramState, x: torch.Tensor, vmin: float,
                     vmax: float) -> HistogramState:
    """Add every value of ``x`` to its bin's count and sum, the index
    clamped to the first and last bin.  The index is computed as the JAX
    package computes it, in float32 throughout (``vmin``, ``vmax`` and
    their difference too) and truncated, so both put a value in the same
    bin."""
    nbins = state.count.shape[0]
    xf = x.reshape(-1).float()
    f32 = dict(dtype=torch.float32, device=xf.device)
    lo, hi = torch.tensor(vmin, **f32), torch.tensor(vmax, **f32)
    # a divisor on the device: PyTorch multiplies by the reciprocal of a
    # host scalar
    idx = torch.clamp(((xf - lo) * nbins / (hi - lo)).to(torch.int32), 0,
                      nbins - 1)
    count = state.count + torch.bincount(idx, minlength=nbins).to(torch.int32)
    return HistogramState(count, state.sum.index_add(0, idx, xf))


class Histogram:
    """Binned counts and sums over ``[vmin, vmax)``, with percentile and
    mean queries on the host."""

    def __init__(self, nbins: int, vmin: float, vmax: float, *, device):
        self.nbins = int(nbins)
        self.vmin = float(vmin)
        self.vmax = float(vmax)
        self.state = histogram_init(self.nbins, device=device)

    def write(self, x) -> None:
        x = torch.as_tensor(x, device=self.state.count.device)
        self.state = histogram_update(self.state, x, self.vmin, self.vmax)

    def bin_value(self, index: int) -> float:
        """The centre of bin ``index``."""
        return self.vmin + (index + 0.5) * (self.vmax - self.vmin) / self.nbins

    def counts(self) -> np.ndarray:
        return self.state.count.cpu().numpy()

    def sums(self) -> np.ndarray:
        return self.state.sum.cpu().numpy()

    def mean_index(self, first: int = 0, last: int | None = None) -> float:
        """The count-weighted mean bin index over ``[first, last)``."""
        c = self.counts()[first:last]
        if c.sum() == 0:
            return 0.0
        return float(np.average(np.arange(len(c)) + first, weights=c))

    def mean_data(self, first: int = 0, last: int | None = None) -> float:
        """The mean of the values that fell in bins ``[first, last)``."""
        c = self.counts()[first:last]
        n = c.sum()
        return float(self.sums()[first:last].sum() / n) if n else 0.0

    def percentile_index(self, fraction: float) -> int:
        """The first bin at which the running count reaches ``fraction``
        of the total."""
        c = self.counts()
        total = c.sum()
        if total == 0:
            return 0
        return int(np.searchsorted(np.cumsum(c), fraction * total))

    def percentile_data(self, fraction: float) -> float:
        return self.bin_value(self.percentile_index(fraction))

    def write_to_file(self, path: str) -> None:
        """One line a bin: index, centre, count, sum, running fraction."""
        c = self.counts()
        s = self.sums()
        cum = np.cumsum(c) / max(int(c.sum()), 1)
        with open(path, "w") as fp:
            for i in range(self.nbins):
                fp.write(f"{i} {self.bin_value(i):.6g} {int(c[i])} "
                         f"{float(s[i]):.6g} {cum[i]:.6f}\n")

    def reset(self) -> None:
        self.state = histogram_init(self.nbins, device=self.state.count.device)
