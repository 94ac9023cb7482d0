"""Communication: the accounting and scaling model of the sharded render
paths, and the two collectives they run.

The counterpart of the JAX package's ``parallel/comms.py``.  The model's
functions are copied as they are: bytes from shapes (``allreduce_bytes``,
``halo_bytes``), a linear time model (``collective_seconds``) and the
projections built on it.  What differs is the link environment,
:class:`CommEnv`, which names H100 links, and the runtime half that XLA
does for JAX from the shardings:

* :func:`halo_exchange` sends each rank's trailing samples to its right
  neighbour (``dist.batch_isend_irecv``), the ``ppermute`` of the
  time-sharded renders;
* :func:`all_reduce_sum`, the ``psum`` of the sharded loudness.

Under gloo a CUDA tensor is staged through pinned host memory, since
gloo's point-to-point takes host tensors; under NCCL the tensors go as
they are.  That is a branch on the group's backend (:func:`host_staged`).
Both collectives add what they moved to this process's counts
(:func:`comm_counts`, :func:`reset_comm_counts`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = [
    "CommEnv",
    "allreduce_bytes",
    "halo_bytes",
    "collective_seconds",
    "scaling_efficiency",
    "config5_scaling_table",
    "time_sharded_efficiency",
    "host_staged",
    "halo_exchange",
    "all_reduce_sum",
    "comm_counts",
    "reset_comm_counts",
]


@dataclass(frozen=True)
class CommEnv:
    """Link parameters for the collective-time model.

    The bandwidths' defaults are ASSUMED, from NVIDIA's data sheets, not
    measured here (a one-card machine has neither link):

    * ``nvlink_bw``: NVLink 4 on an H100 SXM, 900 GB/s in total, so 450
      GB/s a direction, between the cards of one host;
    * ``ib_bw``: one NDR InfiniBand port, 400 Gb/s = 50 GB/s, between
      hosts.

    The latencies have no default: give each with its source.  The model
    is linear in all four, so other values rescale it."""

    nvlink_lat: float         # seconds per hop within a host
    ib_lat: float             # seconds per hop between hosts
    nvlink_bw: float = 4.5e11  # bytes/s a card, a direction (assumed)
    ib_bw: float = 5e10        # bytes/s a host (assumed)


def allreduce_bytes(payload: int, n_devices: int) -> int:
    """Bytes a device moves in a ring all-reduce of ``payload`` bytes over
    ``n_devices``: reduce-scatter and all-gather, ``2 (N-1)/N`` of it."""
    if n_devices <= 1:
        return 0
    return int(2 * (n_devices - 1) * payload / n_devices)


def halo_bytes(c_local: int, nparts: int, block: int,
               dtype_bytes: int = 4) -> int:
    """Bytes a device sends in a time-sharded render's halo exchange: its
    trailing ``nparts * block`` samples of every local channel, to its
    right neighbour (and as many received from its left)."""
    return int(c_local * nparts * block * dtype_bytes)


def collective_seconds(nbytes: int, env: CommEnv, hops_ib: int = 0,
                       hops_nvlink: int = 1) -> float:
    """Model time to move ``nbytes`` a device: the bandwidth term on the
    slowest link class crossed, plus each hop's latency."""
    t = hops_nvlink * env.nvlink_lat + hops_ib * env.ib_lat
    if hops_ib:
        t += nbytes / env.ib_bw
    elif hops_nvlink:
        t += nbytes / env.nvlink_bw
    return t


def scaling_efficiency(compute_seconds: float, comm_seconds: float) -> float:
    """Weak-scaling efficiency when each device's compute stays constant
    and communication is not overlapped: ``t = t_comp + t_comm``."""
    return compute_seconds / (compute_seconds + comm_seconds)


def config5_scaling_table(
    rtf_1chip: float,
    n_chips_list: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
    audio_seconds: float = 1.0,
    channels: int = 1024,
    *,
    env: CommEnv,
    chips_per_host: int = 8,
    loudness_psum: bool = True,
    fs: float = 48000.0,
) -> list[dict]:
    """Scaling projection for BASELINE config #5 (1024 ch x 64k taps),
    channel-sharded: one card's compute for ``C/N`` channels is
    ``audio_seconds / rtf_1chip / N`` (``rtf_1chip`` measured on one card
    at all the channels).  ``efficiency`` counts the collectives only (a
    scalar loudness all-reduce a render, over NVLink within a host and one
    InfiniBand hop across hosts); ``input_bound_rtf`` is the ceiling that a
    host's link sets when the audio arrives over it."""
    rows = []
    for n in n_chips_list:
        t_comp = audio_seconds / rtf_1chip / n
        comm = 0.0
        if loudness_psum and n > 1:
            hops_ib = 1 if n > chips_per_host else 0
            comm += collective_seconds(
                allreduce_bytes(4, n), env, hops_ib=hops_ib)
        eff = scaling_efficiency(t_comp, comm)
        c_local = channels / n
        per_host_in = (c_local * min(n, chips_per_host)
                       * audio_seconds * fs * 4)
        rows.append({
            "chips": n,
            "hosts": max(1, -(-n // chips_per_host)),
            "per_chip_compute_s": t_comp,
            "comm_s": comm,
            "efficiency": eff,
            "aggregate_rtf": rtf_1chip * n * eff,
            "input_bound_rtf": env.ib_bw / per_host_in * audio_seconds,
        })
    return rows


def time_sharded_efficiency(
    rtf_1chip: float,
    span_seconds: float,
    c_local: int,
    nparts: int,
    block: int,
    n_devices: int,
    *,
    env: CommEnv,
    hops_ib: int = 0,
) -> dict:
    """Efficiency of a time-sharded render at a span length: the halo's
    bytes against the span's compute.  The halo moves once a render, not
    once a block, so the efficiency tends to 1 as spans grow."""
    t_comp = span_seconds / rtf_1chip
    nbytes = halo_bytes(c_local, nparts, block)
    t_comm = collective_seconds(nbytes, env, hops_ib=hops_ib)
    return {
        "halo_bytes": nbytes,
        "compute_s": t_comp,
        "comm_s": t_comm,
        "efficiency": scaling_efficiency(t_comp, t_comm),
        "devices": n_devices,
    }


# what this process's collectives moved, by collective
_COUNTS = {name: dict.fromkeys(("calls", "bytes_sent", "bytes_received",
                                "staged_bytes", "seconds"), 0)
           for name in ("halo_exchange", "all_reduce_sum")}


def comm_counts() -> dict:
    """``{collective: {"calls", "bytes_sent", "bytes_received",
    "staged_bytes", "seconds"}}`` since the last reset, in this process.
    The all-reduce's bytes are the ring model's (:func:`allreduce_bytes`);
    seconds are the host's clock around the call, which under NCCL ends
    when the collective is enqueued."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_comm_counts() -> None:
    for v in _COUNTS.values():
        for k in v:
            v[k] = 0


def host_staged(group, t: torch.Tensor) -> bool:
    """Whether a collective over ``group`` stages ``t`` through the host:
    gloo's point-to-point takes host tensors, so a CUDA tensor crosses
    through pinned host memory there; NCCL takes it as it is."""
    return dist.get_backend(group) == "gloo" and t.is_cuda


def _to_host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return buf.copy_(t)


def halo_exchange(tail_x: torch.Tensor, group=None) -> torch.Tensor:
    """The overlap-save halo: each rank sends ``tail_x`` to its right
    neighbour in ``group`` and returns what its left neighbour sent, a
    tensor like ``tail_x`` on its device.  The first rank has no left
    neighbour and gets zeros; in a group of one nothing moves."""
    t0 = time.perf_counter()
    n, i = dist.get_world_size(group), dist.get_rank(group)
    counts = _COUNTS["halo_exchange"]
    counts["calls"] += 1
    src = tail_x.contiguous()
    if n == 1:
        return torch.zeros_like(src)
    staged = host_staged(group, tail_x)
    if staged:
        src = _to_host(src)
        counts["staged_bytes"] += src.nbytes
    halo = torch.zeros(src.shape, dtype=src.dtype, device=src.device,
                       pin_memory=staged and tail_x.is_cuda)
    ops = []
    if i + 1 < n:
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, i + 1), group))
    if i > 0:
        ops.append(dist.P2POp(dist.irecv, halo,
                              dist.get_global_rank(group, i - 1), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    nbytes = src.nbytes
    counts["bytes_sent"] += nbytes if i + 1 < n else 0
    counts["bytes_received"] += nbytes if i > 0 else 0
    if staged:
        counts["staged_bytes"] += nbytes
        halo = halo.to(tail_x.device, non_blocking=True)
    counts["seconds"] += time.perf_counter() - t0
    return halo


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, a new tensor on
    ``t``'s device (``t`` itself is left as it is)."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    staged = host_staged(group, t)
    out = _to_host(t) if staged else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    counts = _COUNTS["all_reduce_sum"]
    counts["calls"] += 1
    moved = allreduce_bytes(out.nbytes, n)
    counts["bytes_sent"] += moved
    counts["bytes_received"] += moved
    if staged:
        counts["staged_bytes"] += 2 * out.nbytes
        out = out.to(t.device, non_blocking=True)
    counts["seconds"] += time.perf_counter() - t0
    return out
