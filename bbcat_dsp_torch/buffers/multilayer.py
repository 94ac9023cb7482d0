"""MultilayerBuffer: mix producers that run at different block sizes into
one stream.

The counterpart of the JAX package's ``buffers/multilayer.py``: a ring of
``[C, capacity]`` on the device and a write cursor a layer on the host.
The frames every layer has written (up to the smallest cursor) are
readable; a write mixes into the ring (scale and add), growing it by
doubling when a producer runs further ahead than it holds; a read can
overwrite or mix into its destination, and frees the slots it read.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MultilayerBuffer"]


class MultilayerBuffer:
    """A device ring of ``capacity`` frames and host-tracked cursors for
    ``nlayers`` producers."""

    def __init__(self, nlayers: int, nchannels: int, capacity: int, *,
                 device, dtype=torch.float32):
        self.nlayers = nlayers
        self.nchannels = nchannels
        self.capacity = int(capacity)
        self.data = torch.zeros((nchannels, self.capacity), dtype=dtype,
                                device=device)
        self.positions = np.zeros(nlayers, np.int64)  # frames written so far
        self.base = 0  # the absolute frame at the front of the ring

    @property
    def min_position(self) -> int:
        """Frames every layer has written: readable up to here."""
        return int(self.positions.min())

    @property
    def max_position(self) -> int:
        return int(self.positions.max())

    def readable(self) -> int:
        return self.min_position - self.base

    def _spans(self, start: int, n: int):
        """``(ring slice, offset in the n frames)`` pairs covering ``n``
        frames from absolute frame ``start``: one, or two over the wrap."""
        s = start % self.capacity
        first = min(n, self.capacity - s)
        spans = [(slice(s, s + first), 0)]
        if first < n:
            spans.append((slice(0, n - first), first))
        return spans

    def reserve_space(self, frames_in_flight: int) -> None:
        """Double the ring until ``frames_in_flight`` frames fit; contents
        and cursors stay."""
        need = int(frames_in_flight)
        if need <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        live = self.max_position - self.base
        frames = self._gather(self.base, live)
        self.capacity = new_cap
        self.data = torch.zeros((self.nchannels, new_cap),
                                dtype=self.data.dtype, device=self.data.device)
        for sl, off in self._spans(self.base, live):
            self.data[:, sl] = frames[:, off:off + sl.stop - sl.start]

    def write_layer(self, layer: int, block: torch.Tensor,
                    mul: float = 1.0) -> None:
        """Mix ``mul * block [C, B]`` at this layer's cursor and advance it,
        growing the ring first where it does not reach."""
        B = block.shape[-1]
        pos = int(self.positions[layer])
        if pos + B - self.base > self.capacity:
            self.reserve_space(pos + B - self.base)
        scaled = mul * block.to(self.data.dtype)
        for sl, off in self._spans(pos, B):
            self.data[:, sl] += scaled[:, off:off + sl.stop - sl.start]
        self.positions[layer] = pos + B

    def _gather(self, start: int, n: int) -> torch.Tensor:
        """A copy of ``n`` frames from absolute frame ``start``."""
        return torch.cat([self.data[:, sl] for sl, _ in self._spans(start, n)],
                         -1)

    def read(self, nframes: int, consume: bool = True) -> torch.Tensor:
        """Up to ``nframes`` readable frames from the front, ``[C, n]``;
        with ``consume`` their slots are zeroed for reuse and the front
        moves past them."""
        n = min(nframes, self.readable())
        out = self._gather(self.base, n)
        if consume and n:
            for sl, _ in self._spans(self.base, n):
                self.data[:, sl] = 0.0
            self.base += n
        return out

    def read_into(self, dst: torch.Tensor, nframes: int, mix: bool = False,
                  mul: float = 1.0) -> torch.Tensor:
        """:meth:`read` into the first frames of ``dst [C, nframes]``,
        overwriting them or, with ``mix``, adding to them: a new tensor."""
        out = self.read(nframes)
        n = out.shape[-1]
        res = dst.clone()
        if mix:
            res[:, :n] += mul * out
        else:
            res[:, :n] = mul * out
        return res

    def reset(self) -> None:
        self.data = torch.zeros_like(self.data)
        self.positions[:] = 0
        self.base = 0
