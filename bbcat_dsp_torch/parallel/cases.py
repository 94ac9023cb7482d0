"""Rank programs: each sharded function driven from whole inputs.

Every rank of a local world (:func:`~bbcat_dsp_torch.parallel.run_local_world`)
runs :func:`run` on the same list of cases.  A case builds its mesh,
makes this rank's shard of the inputs, runs the sharded function once to
load its kernels, then again from the same state with the launch and
communication counts zeroed just before and read just after, and gathers
the output on rank 0.  Inputs are numpy arrays, or :class:`Seeded` rows,
which each rank makes for itself, so that a full-width world pickles no
input into its processes.

These are the programs the CPU tests and ``chip_smoke.py`` run in their
worlds; they live in the package because a spawned rank imports its
program by name, and must import no test module.
"""

from __future__ import annotations

import time
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch

from .. import ops_hook
from ..convolve.block import convolver_init, partition_ir
from ..convolve.nonuniform import NonUniformConvolver
from ..ops.kernels import _build
from . import comms
from .convolve import (
    channel_sharded_nonuniform_render,
    channel_sharded_render,
    channel_sharded_step,
    time_sharded_nonuniform_render,
    time_sharded_render,
)
from .loudness import sharded_integrated_loudness
from .mesh import gather_shards, make_mesh

__all__ = ["Seeded", "run", "CASES"]


class Seeded(NamedTuple):
    """``rows x n`` values made from ``seed``, row ``c`` from a generator of
    its own (``default_rng([seed, c])``), so that any rows can be made
    alone: ``N(0, 1) * exp(-t / decay)`` (no envelope without a
    ``decay``), float64."""

    seed: int
    rows: int
    n: int
    decay: float | None = None

    def make(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        hi = self.rows if hi is None else hi
        env = (np.ones(self.n) if self.decay is None
               else np.exp(-np.arange(self.n) / self.decay))
        return np.stack([np.random.default_rng([self.seed, c])
                         .standard_normal(self.n) * env
                         for c in range(lo, hi)])


def _rows(a, lo: int, hi: int) -> np.ndarray:
    return a.make(lo, hi) if isinstance(a, Seeded) else np.asarray(a)[lo:hi]


def _nrows(a) -> int:
    return a.rows if isinstance(a, Seeded) else np.shape(a)[0]


def _span(mesh, axis: str | None, n: int) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of ``n`` rows cut over ``axis`` (all of
    them for ``None``)."""
    if axis is None:
        return 0, n
    k = n // mesh.size(axis)
    return mesh.index(axis) * k, (mesh.index(axis) + 1) * k


def _signal(x, mesh, device, ch_axis, t_axis=None) -> torch.Tensor:
    """This rank's channels (and time span) of the signal, float32."""
    lo, hi = _span(mesh, ch_axis, _nrows(x))
    xr = _rows(x, lo, hi)
    t_lo, t_hi = _span(mesh, t_axis, xr.shape[1])
    return torch.from_numpy(np.ascontiguousarray(
        xr[:, t_lo:t_hi], np.float32)).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device) -> dict:
    """``fn()`` once to load its kernels, then again with every count
    zeroed just before and read just after: ``{"out", "seconds", "counts",
    "comm"}``."""
    fn()
    _sync(device)
    ops_hook.reset_counts()
    comms.reset_comm_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return {"out": out, "seconds": time.perf_counter() - t0,
            "counts": ops_hook.counts(), "comm": comms.comm_counts()}


def _host(t):
    return None if t is None else t.cpu().numpy()


def _report(run: dict, y, mesh, dims: dict, **extra) -> dict:
    """A case's result: the gathered output (rank 0's, else ``None``),
    this rank's seconds, counts and whether this process compiled the
    kernels."""
    return {"y": _host(gather_shards(y, mesh, dims)),
            "seconds": run["seconds"], "counts": run["counts"],
            "comm": run["comm"], "compiled": bool(_build.BUILD_LOG),
            **extra}


def channel_step(irs, x, block: int, *, device) -> dict:
    """``channel_sharded_step`` over every block of ``x`` from silence;
    also the final state's queue and prev, gathered."""
    mesh = make_mesh(device=device)
    lo, hi = _span(mesh, "ch", _nrows(irs))
    H = partition_ir(_rows(irs, lo, hi), block, device=device)
    xl = _signal(x, mesh, device, "ch")
    step = channel_sharded_step(mesh)

    def go():
        state, ys = convolver_init(hi - lo, block, H.shape[1],
                                   device=device), []
        for k in range(xl.shape[1] // block):
            state, y = step(state, H, xl[:, k * block:(k + 1) * block])
            ys.append(y)
        return state, torch.cat(ys, -1)

    r = _timed(go, device)
    state, y = r["out"]
    return _report(r, y, mesh, {"ch": 0},
                   queue=_host(gather_shards(state.queue, mesh, {"ch": 2})),
                   prev=_host(gather_shards(state.prev, mesh, {"ch": 1})),
                   step=state.step)


def channel_render(irs, x, block: int, *, device) -> dict:
    """``channel_sharded_render`` of ``x`` from silence; also the final
    state's queue, gathered."""
    mesh = make_mesh(device=device)
    lo, hi = _span(mesh, "ch", _nrows(irs))
    H = partition_ir(_rows(irs, lo, hi), block, device=device)
    xl = _signal(x, mesh, device, "ch")
    render = channel_sharded_render(mesh, block)
    state0 = convolver_init(hi - lo, block, H.shape[1], device=device)
    r = _timed(lambda: render(state0, H, xl), device)
    state, y = r["out"]
    return _report(r, y, mesh, {"ch": 0},
                   queue=_host(gather_shards(state.queue, mesh, {"ch": 2})),
                   step=state.step)


def channel_nonuniform(irs, x, block: int, ratio: int, warm: int = 0,
                       gather_state: bool = False, meter_fs=None, *,
                       device) -> dict:
    """The two-level engine on this rank's channels streams the first
    ``warm`` samples of ``x`` by itself, then ``channel_sharded_nonuniform_
    render`` renders the rest from that state (so at the queue slot the
    warm-up left).  With ``gather_state`` the final state's leaves come
    back too; with ``meter_fs`` the output's ``sharded_integrated_loudness``
    at unit weights, its seconds and its communication."""
    mesh = make_mesh(device=device)
    C = _nrows(irs)
    lo, hi = _span(mesh, "ch", C)
    conv = NonUniformConvolver(_rows(irs, lo, hi), block, ratio,
                               device=device)
    xl = _signal(x, mesh, device, "ch")
    if warm:
        conv.process(xl[:, :warm])
    render = channel_sharded_nonuniform_render(mesh, block)
    r = _timed(lambda: render(conv.state, conv.H_head, conv.H_tail,
                              xl[:, warm:].contiguous()), device)
    state, y = r["out"]
    extra = {"tail_step": state.tail.step}
    if gather_state:
        for name, leaf, dim in (("xcarry", state.xcarry, 2),
                                ("prev", state.prev, 1),
                                ("tail.queue", state.tail.queue, 2),
                                ("tail.prev", state.tail.prev, 1),
                                ("pending", state.pending, 1)):
            extra[name] = _host(gather_shards(leaf, mesh, {"ch": dim}))
    if meter_fs is not None:
        meter = sharded_integrated_loudness(mesh, meter_fs, C)
        ones = torch.ones(hi - lo, device=device)
        m = _timed(lambda: meter(y, ones), device)
        extra.update(lkfs=float(m["out"]), meter_seconds=m["seconds"],
                     meter_comm=m["comm"])
    return _report(r, y, mesh, {"ch": 0}, **extra)


def _mesh_axes(mesh_shape):
    """``(shape, names, ch_axis)`` of a time-sharded case's mesh: ``t``
    over the world, or ``(ch, t)``."""
    if mesh_shape is None:
        return None, "t", None
    return tuple(mesh_shape), ("ch", "t"), "ch"


def time_render(irs, x, block: int, mesh_shape=None, *, device) -> dict:
    """``time_sharded_render`` of ``x`` over a ``t`` mesh, or a ``(ch,
    t)`` mesh of ``mesh_shape``."""
    shape, names, ch = _mesh_axes(mesh_shape)
    mesh = make_mesh(shape, names, device=device)
    lo, hi = _span(mesh, ch, _nrows(irs))
    H = partition_ir(_rows(irs, lo, hi), block, device=device)
    xl = _signal(x, mesh, device, ch, "t")
    render = time_sharded_render(mesh, block, H.shape[1], ch_axis=ch)
    r = _timed(lambda: render(H, xl), device)
    dims = {"t": 1} if ch is None else {"ch": 0, "t": 1}
    return _report(r, r["out"], mesh, dims)


def time_nonuniform(irs, x, block: int, ratio: int, mesh_shape=None, *,
                    device) -> dict:
    """``time_sharded_nonuniform_render`` of ``x`` over a ``t`` mesh, or
    a ``(ch, t)`` mesh of ``mesh_shape``."""
    shape, names, ch = _mesh_axes(mesh_shape)
    mesh = make_mesh(shape, names, device=device)
    lo, hi = _span(mesh, ch, _nrows(irs))
    conv = NonUniformConvolver(_rows(irs, lo, hi), block, ratio,
                               device=device)
    xl = _signal(x, mesh, device, ch, "t")
    render = time_sharded_nonuniform_render(
        mesh, block, ratio, conv.head_parts, conv.tail_parts, ch_axis=ch)
    r = _timed(lambda: render(conv.H_head, conv.H_tail, xl), device)
    dims = {"t": 1} if ch is None else {"ch": 0, "t": 1}
    return _report(r, r["out"], mesh, dims, tail_parts=conv.tail_parts)


def loudness(x, w, fs: float, *, device) -> dict:
    """``sharded_integrated_loudness`` of ``x`` at weights ``w``."""
    mesh = make_mesh(device=device)
    C = _nrows(x)
    lo, hi = _span(mesh, "ch", C)
    xl = _signal(x, mesh, device, "ch")
    wl = torch.as_tensor(np.asarray(w, np.float32)[lo:hi], device=device)
    meter = sharded_integrated_loudness(mesh, fs, C)
    r = _timed(lambda: meter(xl, wl), device)
    return {"lkfs": float(r["out"]), "seconds": r["seconds"],
            "comm": r["comm"], "counts": r["counts"]}


def halo(C: int, nparts: int, block: int, seed: int, stand_in=False, *,
         device) -> dict:
    """One ``halo_exchange`` of this rank's own seeded ``[C, nparts *
    block]`` samples over a ``t`` mesh of the world: what the rank sent
    and received, and the bytes counted.  ``stand_in`` takes the branch
    that stages a CUDA tensor through the host, on whatever tensor this
    is (a CPU one stands in for it)."""
    mesh = make_mesh(None, "t", device=device)
    i = mesh.index("t")
    rng = np.random.default_rng([seed, i])
    tail = torch.from_numpy(rng.standard_normal(
        (C, nparts * block)).astype(np.float32)).to(device)
    comms.reset_comm_counts()
    with mock.patch.object(comms, "host_staged",
                           (lambda group, t: True) if stand_in
                           else comms.host_staged):
        got = comms.halo_exchange(tail, mesh.group("t"))
    return {"sent": _host(tail), "halo": _host(got),
            "comm": comms.comm_counts()}


def all_reduce(values, *, device) -> dict:
    """``all_reduce_sum`` of ``values`` times (rank + 1) over the world."""
    mesh = make_mesh(device=device)
    t = torch.as_tensor(np.asarray(values, np.float32), device=device)
    comms.reset_comm_counts()
    got = comms.all_reduce_sum(t * (mesh.index("ch") + 1), mesh.group("ch"))
    return {"sum": _host(got), "comm": comms.comm_counts()}


CASES = {f.__name__: f for f in (channel_step, channel_render,
                                  channel_nonuniform, time_render,
                                  time_nonuniform, loudness, halo,
                                  all_reduce)}


def run(cases, threads: int | None = None, *, device) -> list:
    """Rank program: every ``(name, kwargs)`` of ``cases`` in turn, on
    ``device`` (with ``threads`` host threads for PyTorch, if given); the
    list of their results."""
    if threads is not None:
        torch.set_num_threads(threads)
    return [CASES[name](device=device, **kw) for name, kw in cases]
