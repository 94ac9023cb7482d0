"""Channel-sharded BS.1770 loudness: K-weighting on the shard, one
all-reduce.

The counterpart of the JAX package's ``parallel/loudness.py``.  The
K-weighting and the gating blocks' mean squares are independent across
channels; the weighted channel sum ``z_j = sum_c G_c ms_cj`` is the one
collective (:func:`~bbcat_dsp_torch.parallel.comms.all_reduce_sum` over
the ``"ch"`` group), after which every rank gates the same block powers.
"""

from __future__ import annotations

import torch

from ..loudness.itu1770 import (_block_mean_squares, _gated_mean, _gates,
                                k_weight)
from .comms import all_reduce_sum

__all__ = ["sharded_integrated_loudness"]


def sharded_integrated_loudness(mesh, fs: float, nchannels: int,
                                axis_name: str = "ch"):
    """``(x_local [C_local, T], w_local [C_local]) -> LKFS``, a 0-d tensor
    on the mesh's device, the same on every rank: the gated integrated
    loudness of all ``nchannels`` channels."""
    group = mesh.group(axis_name)
    n = mesh.size(axis_name)
    blk, step = _gates(fs)

    def loudness(x, w):
        if x.shape[0] * n != nchannels:
            raise ValueError(f"{x.shape[0]} channels a shard over {n} "
                             f"shards, built for {nchannels}")
        y, _ = k_weight(x, fs)
        ms = _block_mean_squares(y, blk, step)       # [C_local, nblocks]
        w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
        z_local = torch.sum(w[:, None] * ms, dim=0)
        return _gated_mean(all_reduce_sum(z_local, group))

    return loudness
