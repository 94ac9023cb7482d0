"""Tracing and timing helpers, the counterpart of the JAX package's
``utils/profiling.py``.

:func:`span` marks a layer of the program.  The gate is
``torch.autograd._profiler_enabled()``: with no profiler running a span
is one shared ``contextlib.nullcontext()`` and does nothing else: under
1 us a span, where a bare ``record_function`` costs 8-12 us with no
profiler (torch 2.11 and 2.13).  Under ``torch.profiler`` a span

- enters ``record_function(name)``, so it sits in the profiler's timeline
  on the same clock as the card's kernels;
- tallies, for the names in :data:`SPANS`, its calls, host seconds and
  host self seconds (its seconds less those its child spans cover;
  nesting is per thread);
- where the caller names a CUDA device, records two timing events from a
  pool on that device's current stream, at entry and at exit: their
  ``elapsed_time`` is the span's device extent, from the moment the
  stream reached the span's first work to the end of its last.  The
  engine names its device only for the spans whose extent is read
  (``nonuniform.process`` and ``nonuniform.tail_step``): a pair costs the
  host ~30 us under the profiler.

No span synchronises or launches a kernel.  :func:`tallies` reads the
tallies, ``{name: {"calls", "host_s", "self_s", "device_s", "pending"}}``;
it adds the extents of the event pairs the card has passed (``query()``,
in the order they were recorded) and leaves the rest ``pending``, so a
caller that wants every extent synchronises first.  A span that leaves
:data:`DRAIN_AT` pairs pending resolves them the same way, so a long
profile holds about that many pairs besides those the card has not
passed.  :func:`reset_tallies` zeroes the tallies.

:func:`named_scope` is the decorator form of :func:`span`, :func:`trace`
writes a chrome trace of a block with the card's kernels in it, and
:class:`Timer` times work on the card with CUDA events, having waited for
the card, and work on the CPU with the host's clock.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["SPANS", "DRAIN_AT", "span", "tallies", "reset_tallies",
           "named_scope", "trace", "Timer"]

# the program's spans: the two-level engine's layers (with a device
# extent) and ``ops_hook``'s dispatch of each kernel (host only)
SPANS = ("nonuniform.process", "nonuniform.small_block", "nonuniform.input",
         "nonuniform.head_step", "nonuniform.tail_step",
         "ops_hook.fused_head", "ops_hook.rfft_half",
         "ops_hook.xt_grouped_mac", "ops_hook.irfft_tail",
         "ops_hook.gather_supers", "ops_hook.delayed_add",
         "ops_hook.head_mac", "ops_hook.rotated_mac",
         "ops_hook.xt_step_mac")
_ZERO = {"calls": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
         "pending": 0}
_TALLIES = {name: dict(_ZERO) for name in SPANS}
DRAIN_AT = 128                 # pending pairs at which a span resolves them
_PENDING: list = []            # (tally, device index, start, end) events
_POOL: dict = {}               # device index -> idle timing events
_LOCK = threading.Lock()       # a CUDA backward runs in autograd's thread
_LOCAL = threading.local()     # .stack: this thread's open spans
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    """One span under a running profiler."""

    __slots__ = ("name", "device", "rf", "t0", "child", "events")

    def __init__(self, name: str, device):
        self.name = name
        self.device = (device if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.child = 0.0
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None:
            idx = (self.device.index if self.device.index is not None
                   else torch.cuda.current_device())
            with _LOCK:
                pool = _POOL.setdefault(idx, [])
                e0 = pool.pop() if pool else torch.cuda.Event(
                    enable_timing=True)
                e1 = pool.pop() if pool else torch.cuda.Event(
                    enable_timing=True)
            stream = torch.cuda.current_stream(idx)
            e0.record(stream)
            self.events = (idx, stream, e0, e1)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            idx, stream, e0, e1 = self.events
            e1.record(stream)
        self.rf.__exit__(*exc)
        stack = _LOCAL.stack
        stack.pop()
        host = time.perf_counter() - self.t0
        if stack:
            stack[-1].child += host
        t = _TALLIES.get(self.name)
        if t is not None:
            with _LOCK:
                t["calls"] += 1
                t["host_s"] += host
                t["self_s"] += host - self.child
                if self.events is not None:
                    t["pending"] += 1
                    _PENDING.append((t, idx, e0, e1))
                    if len(_PENDING) >= DRAIN_AT:
                        _resolve()
        return False


def span(name: str, device=None):
    """Context manager: the span ``name``, with a device extent where
    ``device`` is a CUDA device.  With no profiler running, the shared
    null context."""
    if not _profiling():
        return _NULL
    return _Span(name, device)


def _resolve() -> None:
    """Add the extents of the pending pairs, in the order they were
    recorded, up to the first the card has not passed, and put their
    events back in the pool; the caller holds the lock."""
    n = 0
    for t, idx, e0, e1 in _PENDING:
        if not e1.query():
            break
        t["device_s"] += e0.elapsed_time(e1) / 1e3
        t["pending"] -= 1
        _POOL[idx] += (e0, e1)
        n += 1
    del _PENDING[:n]


def tallies() -> dict:
    """``{name: {"calls", "host_s", "self_s", "device_s", "pending"}}``
    for every name in :data:`SPANS`, a copy."""
    with _LOCK:
        _resolve()
        return {name: dict(t) for name, t in _TALLIES.items()}


def reset_tallies() -> None:
    """Zero every tally and drop the pending extents."""
    with _LOCK:
        for _, idx, e0, e1 in _PENDING:
            _POOL[idx] += (e0, e1)
        _PENDING.clear()
        for t in _TALLIES.values():
            t.update(_ZERO)


def named_scope(name: str):
    """Decorator: run the function inside :func:`span` ``(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (host operations, and the card's kernels
    where there is a card) and write ``logdir/trace.json``, a chrome trace
    (``chrome://tracing``, Perfetto)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _devices(tree) -> set:
    """The devices of the tensors in ``tree`` (tensors, tuples, lists,
    dicts)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device}
    if isinstance(tree, (tuple, list)):
        return set().union(*map(_devices, tree))
    if isinstance(tree, dict):
        return set().union(*map(_devices, tree.values()))
    return set()


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Timer:
    """Wall-clock timer that waits for the card: the context manager's
    ``elapsed`` is the host's time from entry to exit, after every card the
    process uses has finished; :meth:`time` times a function."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False

    def time(self, fn, *args, iters: int = 1, **kwargs):
        """Run ``fn`` once to warm up, then ``iters`` times: ``(result,
        seconds a call)``.  Where the result lies on a card the time is
        taken with CUDA events around the calls, else with the host's
        clock; either way after the work has finished."""
        out = fn(*args, **kwargs)
        cuda = [d for d in _devices((out, args, kwargs)) if d.type == "cuda"]
        _sync(cuda)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            _sync(cuda)
            return out, start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        return out, (time.perf_counter() - t0) / iters
