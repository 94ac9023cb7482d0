"""What the readers of the program's own spans share.

``bbcat_dsp_torch`` tallies its spans while a profiler runs
(``utils/profiling.py``: calls, host seconds, host self seconds and, for
``nonuniform.process`` and ``nonuniform.tail_step`` on a card, the device
extent between two CUDA events);
the engine adapter's ``counts()`` carries them under ``"spans"``, and the
tracer diffs them over the traced slice into ``ctx.slice.counters``.  A
program without spans, or a run without a slice, gives nothing to read:
each reader then returns ``None``.
"""

from __future__ import annotations

__all__ = ["tally", "host_ms_per_call", "device_ms_per_call",
           "host_ms_per_unit_of"]


def tally(ctx, name: str):
    """The slice's tally of span ``name``, or ``None`` where the slice
    holds no call of it."""
    sl = ctx.slice
    if sl is None:
        return None
    t = sl.counters.get("spans", {}).get(name)
    return t if t and t.get("calls", 0) > 0 else None


def host_ms_per_call(ctx, name: str):
    """Host ms a call of span ``name``, its children included."""
    t = tally(ctx, name)
    return None if t is None else 1e3 * t["host_s"] / t["calls"]


def device_ms_per_call(ctx, name: str):
    """Device extent in ms a call of span ``name``, over the calls whose
    events the card had passed when the slice closed; ``None`` where it
    has none (no card)."""
    t = tally(ctx, name)
    if t is None:
        return None
    resolved = t["calls"] - t.get("pending", 0)
    if resolved <= 0 or t.get("device_s", 0.0) <= 0:
        return None
    return 1e3 * t["device_s"] / resolved


def host_ms_per_unit_of(ctx, prefix: str, unit: str):
    """The host ms of every span named ``<prefix>*`` over the calls of span
    ``unit``; ``None`` where either is absent."""
    per = tally(ctx, unit)
    if per is None:
        return None
    spans = ctx.slice.counters["spans"]
    host = [t["host_s"] for name, t in spans.items()
            if name.startswith(prefix) and t.get("calls", 0) > 0]
    return 1e3 * sum(host) / per["calls"] if host else None
