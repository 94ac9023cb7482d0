"""Sharding over a ``torch.distributed`` world: channel- and time-sharded
renders of the convolvers with the overlap-save halo exchange, sharded
loudness with one all-reduce, and the communication model.

The counterpart of the JAX package's ``parallel/``.  Each rank is a
process that holds its shard on its own device; the sharded functions
return callables on local tensors (SPMD over a process group), and the
collectives are explicit calls.  :func:`run_local_world` starts a world of
processes on one host: gloo on the CPU, and gloo too when several ranks
share one card (NCCL takes one rank a card).
"""

from .comms import (
    CommEnv,
    all_reduce_sum,
    allreduce_bytes,
    collective_seconds,
    comm_counts,
    config5_scaling_table,
    halo_bytes,
    halo_exchange,
    host_staged,
    reset_comm_counts,
    scaling_efficiency,
    time_sharded_efficiency,
)
from .convolve import (
    channel_sharded_nonuniform_render,
    channel_sharded_render,
    channel_sharded_step,
    time_sharded_nonuniform_render,
    time_sharded_render,
)
from .loudness import sharded_integrated_loudness
from .mesh import (
    Mesh,
    gather_shards,
    make_mesh,
    run_local_world,
    shard_channels,
    shard_state,
)

__all__ = [
    "CommEnv",
    "allreduce_bytes",
    "collective_seconds",
    "config5_scaling_table",
    "halo_bytes",
    "scaling_efficiency",
    "time_sharded_efficiency",
    "host_staged",
    "halo_exchange",
    "all_reduce_sum",
    "comm_counts",
    "reset_comm_counts",
    "Mesh",
    "make_mesh",
    "shard_channels",
    "shard_state",
    "gather_shards",
    "run_local_world",
    "channel_sharded_step",
    "channel_sharded_render",
    "channel_sharded_nonuniform_render",
    "time_sharded_render",
    "time_sharded_nonuniform_render",
    "sharded_integrated_loudness",
]
