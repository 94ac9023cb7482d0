"""``live``: ``process_small_block`` on blocks paced by the audio clock,
an open loop.

Block i is due at ``t0 + (i + 1) * block / sample_rate``: its input is
complete then, in pinned host memory, as in an audio callback, and goes to
the engine as it is (the program moves it to the card).  The output is
copied to pinned host memory; the block's latency runs from its due time
to that copy's end.  The schedule does not slow when the engine does: a
block that starts late waits its turn, and the wait counts in its
latency.  The window holds exactly ``round(seconds * sample_rate /
block)`` blocks.

Input block j is ``pool[j % n]`` of a pool of ``input_pool_blocks``
blocks made on the card from the seed.  Outputs compared: ``keep`` blocks
of the window drawn from the seed among those late enough that the whole
filter and one period of the engine's schedule contribute, and the last
block.

With ``exchange: {"every_blocks": k, "sets": n}`` in the mix, block j (j
> 0, j a multiple of k) first hands the engine the next of the ``n``
filter sets, in turn, inside its timed latency, as a live renderer pays
for it: ``Engine.exchange`` of what ``Engine.prepare`` made of that set
in set-up.  Warm-up then holds an exchange, and a quarter of the compared
blocks are exchange blocks, each with the block after it.
"""

from __future__ import annotations

import contextlib
import math
import time
import traceback

import numpy as np
import torch

from cardbench.core import seeds, signals

__all__ = ["EXCHANGES", "Driver"]

EXCHANGES = True
_NULL = contextlib.nullcontext()


def _wait_until(t: float) -> None:
    """Spin to ``t``.  A sleep wakes late on a shared host (by up to 8 ms,
    p99 1.3 ms, on the card machine), and that lateness would land in the
    program's latency; a spinning loop stands for an audio thread woken on
    time."""
    while time.perf_counter() < t:
        pass


class Driver:
    span = "cardbench.block"

    def __init__(self, run):
        self.run = run
        eng = run.engine
        self.B, self.cycle = eng.block, eng.cycle_blocks
        self.period = self.B / run.cfg["sample_rate"]
        ex = run.traffic.get("exchange")
        self.every = int(ex["every_blocks"]) if ex else 0
        self.prepared = []
        self.j = 0                    # global block index, warm-up included
        self.failed = 0
        self.kept = []
        self.late = self.lat = None

    def _host(self, shape) -> torch.Tensor:
        pin = self.run.device.type == "cuda"
        return torch.empty(shape, pin_memory=pin)

    def setup(self) -> None:
        run, tr = self.run, self.run.traffic
        n = int(tr["input_pool_blocks"])
        pool = signals.noise((n, run.inputs, self.B), run.cfg["signal_rms"],
                             seeds.generator(run.seed, "pool", run.device),
                             run.device)
        self.pool = self._host((n, run.inputs, self.B))
        self.pool.copy_(pool)
        del pool
        self.ring = self._host((2, run.outputs, self.B))
        if self.every:
            self.prepared = [run.engine.prepare(f) for f in run.filters]
        warm = int(tr["warmup_super_blocks"]) * self.cycle
        for _ in range(max(warm, self.every + 1) if self.every else warm):
            self.warm_call()

    def sets(self, j: int) -> tuple[int, int]:
        """The filter sets active before and after block j."""
        if not self.every:
            return 0, 0
        n = len(self.run.filters)
        return (max(j - 1, 0) // self.every % n, j // self.every % n)

    def _block(self, out: torch.Tensor) -> None:
        j = self.j
        if self.every and j and j % self.every == 0:
            self.run.engine.exchange(self.prepared[self.sets(j)[1]])
        y = self.run.engine.live(self.pool[j % self.pool.shape[0]])
        self.j += 1
        out.copy_(y, non_blocking=True)
        self.run.sync()

    def warm_call(self) -> None:
        self._block(self.ring[self.j % 2])

    def plan(self, n: int, base: int, traced: bool):
        """The window's compared blocks (indices in the window, the last
        one included) and its traced slice ``[s0, s1)``, ``(-1, -1)``
        untraced, for a window of ``n`` blocks after ``base``."""
        run, tr = self.run, self.run.traffic
        # late enough: the whole filter's history and one cycle behind it
        first = max(0, math.ceil((run.memory + 1) / self.B) + self.cycle
                    - base)
        pick = list(range(first, n - 1))
        rng = seeds.host_rng(run.seed, "keep")
        keep = int(tr["keep"])
        if not self.every:
            idx = sorted(rng.sample(pick, min(keep, len(pick))))
        else:
            due = [i for i in pick[:-1] if (base + i) % self.every == 0]
            if not due:
                raise ValueError(f"a window of {n} blocks holds no exchange "
                                 f"block late enough to compare")
            took = {k for i in rng.sample(due, min(len(due),
                                                   max(1, keep // 4)))
                    for k in (i, i + 1)}
            rest = [i for i in pick if i not in took]
            took.update(rng.sample(rest, min(max(0, keep - len(took)),
                                             len(rest))))
            idx = sorted(took)
        idx.append(n - 1)
        s0 = s1 = -1
        if traced:
            s0 = next(i for i in range(min(8, n - 1), n)
                      if (base + i) % self.cycle == 0)
            s1 = min(n, s0 + int(tr["trace_slice"]["super_blocks"])
                     * self.cycle)
        return idx, (s0, s1)

    def window(self, seconds: float, tracer=None) -> dict:
        n = max(1, round(seconds / self.period))
        base = self.j
        idx, (s0, s1) = self.plan(n, base, tracer is not None)
        slot = {i: q for q, i in enumerate(idx)}
        slots = self._host((len(idx), self.run.outputs, self.B))
        lat = np.zeros(n)
        late = np.zeros(n)
        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + (i + 1) * self.period
            if i == s0:
                tracer.start()
            with (tracer.span("cardbench.wait") if s0 <= i < s1 else _NULL):
                _wait_until(due)
            start = time.perf_counter()
            out = slots[slot[i]] if i in slot else self.ring[i % 2]
            try:
                with (tracer.span() if s0 <= i < s1 else _NULL):
                    self._block(out)
                ok = True
            except Exception:
                if not self.failed:
                    traceback.print_exc()
                self.j = base + i + 1
                out.fill_(float("nan"))
                ok = False
            done = time.perf_counter()
            lat[i], late[i] = done - due, start - due
            # a block fails if it raised or if its output is not finite
            self.failed += not (ok and math.isfinite(float(out.sum())))
            if i == s1 - 1:
                tracer.stop(units=s1 - s0)
        self.lat, self.late = lat, late
        self.kept = [((base + i) * self.B, slots[q], self.sets(base + i))
                     for i, q in slot.items()]
        return {"attempted": n, "failed": self.failed, "latency_s": lat,
                "late_s": late, "period_s": self.period}

    def stream(self, start: int, length: int) -> torch.Tensor:
        """Samples ``[start, start + length)`` of the input stream on the
        device, ``[inputs, length]``, zeros before its first sample."""
        parts, t = [], start
        while t < start + length:
            j, off = divmod(t, self.B)
            m = min(self.B - off, start + length - t)
            parts.append(torch.zeros((self.run.inputs, m)) if j < 0 else
                         self.pool[j % self.pool.shape[0]][:, off:off + m])
            t += m
        return torch.cat(parts, dim=1).to(self.run.device)

    def info(self) -> list[str]:
        if self.lat is None:
            return []
        miss = int((self.lat > self.period).sum())
        return [f"live: {len(self.lat)} blocks, deadline {self.period * 1e3:.4f}"
                f" ms, {miss} missed it; latency median "
                f"{np.median(self.lat) * 1e3:.4f} ms, max "
                f"{self.lat.max() * 1e3:.4f} ms",
                f"live: the generator ran late by median "
                f"{np.median(self.late) * 1e3:.4f} ms, p99 "
                f"{np.percentile(self.late, 99) * 1e3:.4f} ms, max "
                f"{self.late.max() * 1e3:.4f} ms"]

