"""One bounded, steady slice of a window under ``torch.profiler``, and
what the per-layer readers take from it.

The slice starts and ends on a synchronise, so every device operation in
it belongs to a call in it.  ``torch.profiler`` traces CPU and CUDA
activities, with no stacks and no shapes; the chrome trace goes to a
temporary file in ``TMPDIR`` that is read and deleted at once.  Only the
slice is traced, never the whole window.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

__all__ = ["Tracer", "Slice", "parse", "kernel_base_name", "merge",
           "covered", "gaps"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "(no host op)"


def kernel_base_name(name: str) -> str:
    """``void (anonymous namespace)::windows_kernel<512>(float const*, ...)``
    -> ``windows_kernel``: the identifier a mapping file is named by."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^(void|static)\s+", "", s.strip())
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1] or name


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def gaps(intervals, lo: float, hi: float):
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for a, b in merge(intervals):
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


class _Innermost:
    """The innermost host operation at each moment, on one thread: a
    sorted list of change points, each with the name that holds from it
    on (``None`` outside every operation)."""

    def __init__(self, events):
        points, stack = [], []
        for name, a, b in sorted(events, key=lambda e: (e[1], -e[2])):
            while stack and stack[-1][1] <= a:
                end = stack.pop()[1]
                points.append((end, stack[-1][0] if stack else None))
            stack.append((name, b))
            points.append((a, name))
        while stack:
            end = stack.pop()[1]
            points.append((end, stack[-1][0] if stack else None))
        self.times = [p[0] for p in points]
        self.names = [p[1] for p in points]

    def split(self, a: float, b: float):
        """``[(name, seconds)]``: ``[a, b)`` cut where the innermost host
        operation changes."""
        out, t = [], a
        i = bisect.bisect_right(self.times, a) - 1
        while t < b:
            name = self.names[i] if i >= 0 else None
            end = min(b, self.times[i + 1]) if i + 1 < len(self.times) else b
            if end > t:
                out.append((NO_HOST_OP if name is None else name, end - t))
                t = end
            i += 1
        return out


class Slice:
    """What a slice held: ``units`` calls (or blocks), the span from the
    first call's start to the last device operation's or call's end, the
    device's busy seconds in it, every device operation as ``(name, cat,
    start, end)`` (seconds), the idle gaps labelled by the host, and the
    program's counters over the slice."""

    def __init__(self, units, lo, hi, device_ops, host_ops, counters):
        self.units = units
        self.lo = lo          # the tests read where the span begins and ends
        self.hi = hi
        self.span_s = hi - lo
        self.device_ops = device_ops
        self.busy_s = covered([(a, b) for _, _, a, b in device_ops], lo, hi)
        self.kernels = [(n, b - a) for n, c, a, b in device_ops if c == "kernel"]
        inner = _Innermost(host_ops)
        self.idle = [part for a, b in gaps([(a, b) for _, _, a, b in
                                            device_ops], lo, hi)
                     for part in inner.split(a, b)]
        self.counters = counters

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by what the host was doing meanwhile (the innermost host
        operation at each moment of each gap), seconds summed by name."""
        def ranked(pairs):
            acc = {}
            for name, s in pairs:
                acc[name] = acc.get(name, 0.0) + s
            return [[k, v] for k, v in sorted(acc.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked((n, b - a)
                                     for n, _, a, b in self.device_ops),
                "idle_gaps": ranked(self.idle)}


def parse(events, span_name: str, units: int, counters: dict) -> Slice:
    """A :class:`Slice` from chrome-trace events, whose calls are the host
    spans named ``span_name``."""
    xs = [e for e in events if e.get("ph") == "X"]
    calls = [e for e in xs if e.get("cat") == "user_annotation"
             and e.get("name") == span_name]
    if not calls:
        raise RuntimeError(f"the trace holds no {span_name!r} span")
    tid = calls[0].get("tid")

    def sec(e):
        a = float(e["ts"]) * 1e-6
        return a, a + float(e.get("dur", 0.0)) * 1e-6

    lo = min(sec(e)[0] for e in calls)
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = sec(e)
            if b > lo:
                name = (kernel_base_name(e["name"]) if e["cat"] == "kernel"
                        else e["name"])
                dev.append((name, e["cat"], max(a, lo), b))
    hi = max([sec(e)[1] for e in calls] + [b for _, _, _, b in dev])
    host = [(e["name"], *sec(e)) for e in xs
            if e.get("cat") in HOST_CATS and e.get("tid") == tid]
    return Slice(units, lo, hi, dev, host, counters)


def _diff(after, before):
    if isinstance(after, dict):
        return {k: _diff(v, before.get(k, 0) if isinstance(before, dict)
                         else 0) for k, v in after.items()}
    return after - before


class Tracer:
    """Profiles one slice: :meth:`start` and :meth:`stop` each synchronise
    first; :meth:`span` wraps a call in ``record_function`` while the
    slice is open; :meth:`read`, after the window, parses it into
    :attr:`slice`."""

    def __init__(self, device, span_name: str, counters):
        self.device = torch.device(device)
        self.span_name = span_name
        self.counters = counters
        self.prof = None
        self.slice = None
        self._c0 = None

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, fn) -> None:
        """Profile ``fn`` once and drop it: the profiler's first start is
        slow, and belongs in set-up."""
        self._sync()
        with torch.profiler.profile(activities=self._activities()):
            fn()
            self._sync()

    def span(self, name: str | None = None):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name or self.span_name)

    def start(self) -> None:
        self._sync()
        self._c0 = self.counters()
        self.prof = torch.profiler.profile(
            activities=self._activities(), record_shapes=False,
            with_stack=False, profile_memory=False)
        self.prof.start()

    def stop(self, units: int) -> None:
        """Close the slice; :meth:`read` parses it once the window is
        over."""
        self._sync()
        self._done, self.prof = self.prof, None
        self._done.stop()
        self._units = units
        self._counters = _diff(self.counters(), self._c0)

    def read(self) -> Slice:
        prof = self._done
        fd, path = tempfile.mkstemp(suffix=".json", prefix="cardbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.slice = parse(events, self.span_name, self._units,
                           self._counters)
        return self.slice
