"""A circular buffer as an explicit state: ``(data [..., L], writepos)``.

The counterpart of the JAX package's ``buffers/ring.py``: channel axes
lead, time is last, and every function returns a new :class:`Ring` and
leaves the one it was given untouched, so a caller may keep an earlier
state.  The write position is a Python integer on the host (as the
convolvers' ``step`` is): it counts every sample ever written or skipped,
and is reduced modulo the length, in integers, wherever a place in the
buffer is computed from it.  The JAX package shapes its write around the
TPU's slow scatters (an ``L + B`` extension and masked selects); here a
write is one concatenation of at most three slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import storage_dtype

__all__ = ["Ring", "ring_init", "ring_write", "ring_read_delayed",
           "ring_advance"]


class Ring(NamedTuple):
    data: torch.Tensor   # [..., length]
    writepos: int        # samples written or skipped so far (never wraps)


def ring_init(shape, length: int, dtype=torch.float32, *, device) -> Ring:
    """A silent ring of ``length`` samples for a batch ``shape``, stored in
    ``dtype`` (float32, bfloat16 or float16): a write rounds to it."""
    return Ring(torch.zeros(tuple(shape) + (int(length),),
                            dtype=storage_dtype(dtype, "ring"), device=device),
                0)


def ring_write(ring: Ring, block: torch.Tensor) -> Ring:
    """Write ``block [..., B]`` (broadcast over the ring's leading axes) at
    the cursor and advance it by ``B``; ``B`` may not exceed the length."""
    L = ring.data.shape[-1]
    B = block.shape[-1]
    if B > L:
        raise ValueError(f"block ({B}) longer than ring ({L})")
    start = ring.writepos % L
    # the one rounding of a narrow ring
    blk = block.to(ring.data.dtype).expand(ring.data.shape[:-1] + (B,))
    over = start + B - L          # samples that wrap to the front
    if over <= 0:
        parts = (ring.data[..., :start], blk, ring.data[..., start + B:])
    else:
        parts = (blk[..., B - over:], ring.data[..., over:start],
                 blk[..., :B - over])
    return Ring(torch.cat(parts, dim=-1), ring.writepos + B)


def ring_read_delayed(ring: Ring, delay: int, n: int = 1) -> torch.Tensor:
    """``n`` consecutive samples starting ``delay`` samples behind the
    cursor: ``[..., n]``, or ``[...]`` for ``n = 1``."""
    L = ring.data.shape[-1]
    if not 1 <= n <= L:
        raise ValueError(f"n = {n} outside 1 .. {L}, the ring's length")
    start = (ring.writepos - int(delay)) % L
    if start + n <= L:
        out = ring.data[..., start:start + n]
    else:
        out = torch.cat([ring.data[..., start:],
                         ring.data[..., :start + n - L]], dim=-1)
    return out[..., 0] if n == 1 else out


def ring_advance(ring: Ring, n: int) -> Ring:
    """Advance the cursor by ``n`` samples without writing."""
    return Ring(ring.data, ring.writepos + int(n))
