"""The pod deployment, walked through on one host: a world of ranks renders
a two-level convolver channel-sharded, meters it with one all-reduce, and
checks both against one process.

    python -m bbcat_dsp_torch.examples.pod_render

The port of the JAX package's ``examples/pod_render.py``, at its
geometry (128 channels, block 128, ratio 16).  Where JAX simulates eight
devices in one process, this starts ``world`` processes
(:func:`~bbcat_dsp_torch.parallel.run_local_world`, gloo: several ranks
share one card, which NCCL refuses).  Each rank builds the engine, takes
its channels of the state and spectra (``shard_state``,
``shard_channels``) and renders them (K1-K6 on the card), then meters the
output with ``sharded_integrated_loudness``.  The checks: the gathered
output against the engine in one process (>= 110 dB), the sharded
loudness against the unsharded meter (within 1e-4 LU); then the
communication model's bytes and the config #5 projection from the
single-process render's real-time factor that this run measures.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import ops_hook
from ..convolve import NonUniformConvolver
from ..loudness import integrated_loudness
from ..parallel import (
    CommEnv,
    all_reduce_sum,
    channel_sharded_nonuniform_render,
    comm_counts,
    config5_scaling_table,
    gather_shards,
    make_mesh,
    reset_comm_counts,
    run_local_world,
    shard_channels,
    shard_state,
    sharded_integrated_loudness,
)
from ..tools._device import cli_device

__all__ = ["main"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_rank(irs, x, block: int, ratio: int, fs: float, *,
                device) -> dict:
    """Rank program: the engine on all channels, this rank's channels of
    its state and spectra rendered, their loudness metered with the other
    ranks'; the output gathered on rank 0."""
    mesh = make_mesh(device=device)
    conv = NonUniformConvolver(irs, block, ratio, device=device)
    render = channel_sharded_nonuniform_render(mesh, block)
    xl = shard_channels(torch.from_numpy(x), mesh)
    _sync(device)
    ops_hook.reset_counts()
    _, y = render(shard_state(conv.state, mesh),
                  shard_channels(conv.H_head, mesh, 2),
                  shard_channels(conv.H_tail, mesh, 2), xl)
    _sync(device)
    counts = ops_hook.counts()
    meter = sharded_integrated_loudness(mesh, fs, x.shape[0])
    reset_comm_counts()
    lkfs = float(meter(y, shard_channels(torch.ones(x.shape[0]), mesh)))
    comm = comm_counts()
    # scalar all-reduces with every rank at the start line: the
    # collective's own round trip, without the ranks' skew; the median of
    # five, the first of which also makes the staging buffers
    trips = []
    for _ in range(5):
        dist.barrier()
        t0 = time.perf_counter()
        all_reduce_sum(torch.ones(1, device=device))
        _sync(device)
        trips.append(time.perf_counter() - t0)
    round_trip = statistics.median(trips)
    whole = gather_shards(y, mesh, {"ch": 0})
    return {"y": None if whole is None else whole.cpu().numpy(),
            "lkfs": lkfs, "counts": counts, "comm": comm,
            "round_trip": round_trip}


def main(C: int = 128, block: int = 128, ratio: int = 16,
         n_super: int = 48, world: int = 4, seed: int = 0, *,
         device="cuda", timeout: float = 600.0, log=print) -> dict:
    """Render ``n_super`` super-blocks of ``C`` channels through IRs of four
    super-blocks, in one process and channel-sharded over ``world`` ranks;
    ``{"snr_db", "lkfs", "lkfs_ref", "rtf", "allreduce_bytes",
    "round_trip", "rows", "ranks"}``: ``round_trip`` the slowest rank's
    median scalar all-reduce in seconds, ``ranks`` each rank's launch and
    communication counts.
    Raises ``AssertionError`` if a check fails."""
    dev = cli_device(device, "pod_render")
    fs = 48000.0
    SB = block * ratio
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((C, 4 * SB)) * np.exp(
        -np.arange(4 * SB) / (SB / 2.0))
    # >= 0.4 s, so that BS.1770's gating blocks exist
    x = (0.1 * rng.standard_normal((C, n_super * SB))).astype(np.float32)

    # ---- one process: the reference, and the real-time factor
    conv = NonUniformConvolver(irs, block, ratio, device=dev)
    xd = torch.from_numpy(x).to(dev)
    conv.process(xd)
    conv.reset()
    _sync(dev)
    t0 = time.perf_counter()
    y_ref = conv.process(xd)
    _sync(dev)
    rtf = x.shape[1] / fs / (time.perf_counter() - t0)
    lkfs_ref = float(integrated_loudness(y_ref, fs))
    y_ref = y_ref.cpu().numpy()

    # ---- the same engine, channel-sharded over a world of processes
    ranks = run_local_world(render_rank, world,
                            args=(irs, x, block, ratio, fs),
                            backend="gloo", device=dev, timeout=timeout)
    y = ranks[0]["y"]
    err = np.sum((y_ref.astype(np.float64) - y.astype(np.float64)) ** 2)
    sig = np.sum(y_ref.astype(np.float64) ** 2)
    snr = float("inf") if err == 0 else float(10 * np.log10(sig / err))
    lkfs = ranks[0]["lkfs"]

    # ---- what the world communicated, and the config #5 projection
    ar = [r["comm"]["all_reduce_sum"] for r in ranks]
    nbytes = ar[0]["bytes_sent"]
    # latency: this run's slowest rank's scalar all-reduce round trip
    # (gloo on one host), in place of a link's, for which
    # no figure is given here; the table also shows none at all
    lat = max(r["round_trip"] for r in ranks)
    rows = config5_scaling_table(rtf, (1, 2, 4, 8),
                                 env=CommEnv(nvlink_lat=lat, ib_lat=lat))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    log(f"world                   : {world} ranks, gloo, every rank "
        f"on {dev} ({name})")
    log(f"engine                  : NonUniform C={C} B={block} "
        f"ratio={ratio}, {x.shape[1]} samples")
    log(f"sharded vs single       : {snr:.1f} dB SNR (contract >= 110)")
    log(f"loudness (all-reduce)   : {lkfs:.6f} LKFS (unsharded "
        f"{lkfs_ref:.6f})")
    log(f"collective bytes/render : {nbytes} a rank (the loudness "
        f"all-reduce of the block powers; the render itself moves none)")
    log(f"scaling, from this run's single-process render at "
        f"{rtf:.2f}x real time on {name} (C={C}), latency {lat * 1e6:.1f} "
        f"us (this run's scalar all-reduce), bandwidths assumed from the H100 "
        f"data sheets:")
    free = config5_scaling_table(rtf, (1, 2, 4, 8),
                                 env=CommEnv(nvlink_lat=0.0, ib_lat=0.0))
    for r, r0 in zip(rows, free):
        log(f"  {r['chips']:2d} cards: {r['aggregate_rtf']:9.1f}x RT at "
            f"{100 * r['efficiency']:5.1f}% efficiency "
            f"({100 * r0['efficiency']:.4f}% with no latency)")
    assert snr >= 110.0, f"sharded render diverged: {snr:.1f} dB"
    assert all(r["lkfs"] == lkfs for r in ranks), [r["lkfs"] for r in ranks]
    assert abs(lkfs - lkfs_ref) < 1e-4, (lkfs, lkfs_ref)
    return {"snr_db": snr, "lkfs": lkfs, "lkfs_ref": lkfs_ref, "rtf": rtf,
            "allreduce_bytes": nbytes, "round_trip": lat, "rows": rows,
            "ranks": [{"counts": r["counts"], "comm": r["comm"]}
                      for r in ranks]}


if __name__ == "__main__":
    main()
