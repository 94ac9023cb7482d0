"""Meshes over a ``torch.distributed`` world, shards, and local worlds.

The counterpart of the JAX package's ``parallel/mesh.py``.  JAX builds a
``Mesh`` of devices in one process and places global arrays on it; here
every rank is a process of its own that holds only its shard, on its own
device, and the collectives are explicit calls (:mod:`.comms`).  So

* :func:`make_mesh` names one or two axes over the world that
  ``torch.distributed`` already runs (``"ch"`` for channels, ``"t"`` for
  time spans), through :class:`~torch.distributed.device_mesh.DeviceMesh`;
* :func:`shard_channels` and :func:`shard_state` cut this rank's
  contiguous slice out of a whole tensor or engine state;
* :func:`gather_shards` assembles the shards on one rank, what
  ``np.asarray`` of a sharded array does in JAX;
* :func:`run_local_world` starts a world of processes on this host, the
  counterpart of the JAX tests' eight virtual CPU devices.

A mesh's collectives run where its backend runs them: gloo's on the host,
NCCL's on the card.  The shards live on the mesh's ``device`` either way.
"""

from __future__ import annotations

import datetime
import pickle
import queue
import socket
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .comms import host_staged

__all__ = ["Mesh", "make_mesh", "shard_channels", "shard_state",
           "gather_shards", "run_local_world"]


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a named mesh: the ranks' layout and process
    groups (``device_mesh``) and the device its shards live on."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.device_mesh.size(self._dim(axis))

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.device_mesh.get_local_rank(self._dim(axis))

    def group(self, axis: str):
        """The process group of the ranks that share this rank's position
        on every other axis."""
        return self.device_mesh.get_group(self._dim(axis))


def _device(device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the
    current one, so that shards and the tensors made for them compare
    equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices=None, axis_name="ch", *, device) -> Mesh:
    """A mesh over the whole world of the running process group.

    ``n_devices`` and ``axis_name`` are an int and a name for one axis
    (``n_devices`` defaults to the world size), or tuples of both for two
    axes, e.g. ``make_mesh((2, 2), ("ch", "t"), device=dev)``; the sizes'
    product is the world size.  Ranks are laid out row-major, the last axis fastest."""
    world = dist.get_world_size()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    n = n_devices
    shape = (world,) if n is None else (n,) if isinstance(n, int) else tuple(n)
    if len(shape) != len(names) or len(names) not in (1, 2):
        raise ValueError(f"mesh of shape {shape} with axes {names}: one or "
                         "two axes, one size each")
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh of shape {shape} over a world of {world}")
    host = dist.get_backend() != "nccl"
    dm = init_device_mesh("cpu" if host else "cuda", shape,
                          mesh_dim_names=names)
    return Mesh(dm, _device(device))


def _slice(t: torch.Tensor, mesh, dim: int, axis: str) -> torch.Tensor:
    n, i = mesh.size(axis), mesh.index(axis)
    if t.shape[dim] % n:
        raise ValueError(f"{t.shape[dim]} rows on dim {dim} do not split "
                         f"over {n} shards of axis {axis!r}")
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k)


def shard_channels(arr, mesh, channel_axis: int = 0,
                   axis_name: str = "ch") -> torch.Tensor:
    """This rank's contiguous slice of ``arr`` along ``channel_axis``,
    contiguous and on the mesh's device.  Any axis of ``arr`` can be cut
    over any axis of the mesh (time spans: ``channel_axis=1,
    axis_name="t"``)."""
    return _slice(torch.as_tensor(arr), mesh, channel_axis,
                  axis_name).contiguous().to(mesh.device)


def shard_state(state, mesh, axis_name: str = "ch"):
    """This rank's channels of a ``NonUniformState`` or ``ConvolverState``,
    leaf by leaf: the channel axis is 2 of ``xcarry`` and every queue, 1 of
    every ``prev`` and of ``pending``; the host ``step`` is replicated."""
    def cut(t, dim):
        return shard_channels(t, mesh, dim, axis_name)

    if hasattr(state, "xcarry"):
        return state._replace(xcarry=cut(state.xcarry, 2),
                              prev=cut(state.prev, 1),
                              tail=shard_state(state.tail, mesh, axis_name),
                              pending=cut(state.pending, 1))
    return state._replace(queue=cut(state.queue, 2), prev=cut(state.prev, 1))


def gather_shards(t: torch.Tensor, mesh: Mesh,
                  dims: dict) -> torch.Tensor | None:
    """Assemble on global rank 0 the whole tensor whose shards the ranks
    hold; ``dims`` maps each mesh axis the tensor is cut over to the
    tensor's dim (``{"ch": 0, "t": 1}``); over the other axes the shards
    are replicas, and the first is taken.  Returns the whole tensor on the
    mesh's device at rank 0, ``None`` on every other rank."""
    world, rank = dist.get_world_size(), dist.get_rank()
    staged = host_staged(None, t)
    src = t.detach().contiguous()
    src = src.cpu() if staged else src
    bufs = [torch.empty_like(src) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(src, bufs, dst=0)
    if rank != 0:
        return None
    names = mesh.axis_names
    layout = mesh.device_mesh.mesh          # global rank at each position
    shape = list(src.shape)
    for axis, dim in dims.items():
        shape[dim] *= mesh.size(axis)
    out = src.new_empty(shape)
    for r in range(world):
        pos = [int(c) for c in (layout == r).nonzero()[0]]
        if any(pos[k] for k, a in enumerate(names) if a not in dims):
            continue
        view = out
        for axis, dim in dims.items():
            k = src.shape[dim]
            view = view.narrow(dim, pos[names.index(axis)] * k, k)
        view.copy_(bufs[r])
    return out.to(mesh.device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, timeout, work, out):
    """One rank of :func:`run_local_world`: take ``(fn, args)`` from
    ``work``, join the group, run ``fn``, report ``(rank, ok, pickled
    result or traceback)`` on ``out``."""
    try:
        fn, args = work.get(timeout=timeout)
        dev = _device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(*args, device=dev)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_local_world(fn, world: int, *, args=(), backend: str, device,
                    timeout: float) -> list:
    """Run ``fn(*args, device=device)`` on every rank of a world of
    ``world`` processes on this host (``spawn``; ``backend`` ``"gloo"`` or
    ``"nccl"``; the group's address is a free port on ``localhost``) and
    return the ranks' results in rank order.

    ``fn`` must be importable by name (a function at the top of a module)
    and its result picklable.  Raises if a rank raises or dies, and
    ``TimeoutError`` if the ranks have not all finished ``timeout``
    seconds after the start, which is also the group's own timeout for a
    collective; the other ranks are then ended, so no rank outlives the
    call."""
    ctx = mp.get_context("spawn")
    work, out = ctx.Queue(), ctx.Queue()
    port = _free_port()
    # the work goes through a queue, not the processes' arguments: a
    # spawned process reads its arguments only after its imports, and
    # the parent would wait for each in turn
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, str(device), timeout,
                               work, out), daemon=True)
             for r in range(world)]
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in procs:
            work.put((fn, tuple(args)))
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"ranks {missing} of {world} did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead and out.empty():
                    raise RuntimeError(
                        f"ranks {dead} ended with exit codes "
                        f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = pickle.loads(payload)
    finally:
        # work no rank took (a world that ended early) must not hold this
        # process at its exit, waiting for a reader
        work.cancel_join_thread()
        for p in procs:
            p.join(timeout=10 if len(results) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
