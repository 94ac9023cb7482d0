"""Tracing and timing helpers, the counterpart of the JAX package's
``utils/profiling.py``.

:func:`named_scope` groups a function's operations under a name in
``torch.profiler`` timelines (``record_function``), :func:`trace` writes
a chrome trace of a block with the card's kernels in it, and
:class:`Timer` times work on the card with CUDA events, having waited for
the card, and work on the CPU with the host's clock.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["named_scope", "trace", "Timer"]


def named_scope(name: str):
    """Decorator: run the function inside ``record_function(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
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
