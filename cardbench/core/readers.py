"""What the metric readers (``metrics/<name>.py``) share.  Each takes the
run's :class:`~cardbench.core.cell.Context` and returns a number, or
``None`` where the run holds nothing for it to read."""

from __future__ import annotations

import numpy as np

from cardbench.core.costs import bound_s

__all__ = ["rtf", "p99_ms", "launches_per_unit", "idle_pct",
           "busy_ms_per_unit", "roofline_pct"]


def rtf(ctx):
    """Audio seconds over the wall seconds of the whole window."""
    w = ctx.window
    return w["audio_s"] / w["wall_s"] if "audio_s" in w else None


def p99_ms(ctx):
    """numpy's linear 99th percentile of every block's latency, in ms."""
    lat = ctx.window.get("latency_s")
    return None if lat is None else float(np.percentile(lat, 99) * 1e3)


def launches_per_unit(ctx):
    """Kernel records in the traced slice over its calls or blocks."""
    sl = ctx.slice
    return len(sl.kernels) / sl.units if sl is not None and sl.kernels else None


def idle_pct(ctx):
    """100 x (1 - device busy / the slice's span)."""
    sl = ctx.slice
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.span_s)


def busy_ms_per_unit(ctx):
    """Device busy ms in the traced slice over its calls or blocks."""
    sl = ctx.slice
    if sl is None or sl.busy_s <= 0:
        return None
    return 1e3 * sl.busy_s / sl.units


def roofline_pct(ctx, function: str):
    """100 x the least time of ``function``'s calls in the slice (their
    count from the program's counter, their shapes from the engine
    adapter) over the device time of every kernel that ``kernels/*.json``
    maps to ``function``; ``None`` where the slice holds none of them."""
    sl = ctx.slice
    roof = ctx.bench.roofline(function)
    shapes = ctx.shapes.get(function)
    if sl is None or roof is None or shapes is None:
        return None
    busy = sum(s for name, s in sl.kernels
               if ctx.kernel_functions.get(name) == function)
    calls = sl.counters.get("launches", {}).get(roof.COUNTER, 0)
    if busy <= 0 or calls <= 0:
        return None
    return 100.0 * calls * bound_s(*roof.cost(**shapes))[0] / busy
