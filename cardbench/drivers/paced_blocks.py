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
of the window drawn from the seed among those late enough that the head
and every tail partition contribute, and the last block.
"""

from __future__ import annotations

import contextlib
import math
import time
import traceback

import numpy as np
import torch

from cardbench.core import seeds, signals

__all__ = ["Driver"]

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
        self.B, self.ratio, self.C = eng.block, eng.ratio, run.cfg["channels"]
        self.period = self.B / run.cfg["sample_rate"]
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
        pool = signals.noise((n, self.C, self.B), run.cfg["signal_rms"],
                             seeds.generator(run.seed, "pool", run.device),
                             run.device)
        self.pool = self._host((n, self.C, self.B))
        self.pool.copy_(pool)
        del pool
        self.ring = self._host((2, self.C, self.B))
        for _ in range(int(tr["warmup_super_blocks"]) * self.ratio):
            self.warm_call()

    def _block(self, out: torch.Tensor) -> None:
        y = self.run.engine.live(self.pool[self.j % self.pool.shape[0]])
        self.j += 1
        out.copy_(y, non_blocking=True)
        self.run.sync()

    def warm_call(self) -> None:
        self._block(self.ring[self.j % 2])

    def window(self, seconds: float, tracer=None) -> dict:
        run, tr = self.run, self.run.traffic
        n = max(1, round(seconds / self.period))
        base = self.j
        # late enough: the whole IR's history and one tail firing behind it
        first = max(0, math.ceil(run.cfg["ir_taps"] / self.B) + self.ratio
                    - base)
        pick = list(range(first, n - 1))
        rng = seeds.host_rng(run.seed, "keep")
        idx = sorted(rng.sample(pick, min(int(tr["keep"]), len(pick))))
        idx.append(n - 1)
        slot = {i: q for q, i in enumerate(idx)}
        slots = self._host((len(idx), self.C, self.B))
        s0 = s1 = -1
        if tracer is not None:
            s0 = next(i for i in range(min(8, n - 1), n)
                      if (base + i) % self.ratio == 0)
            s1 = min(n, s0 + int(tr["trace_slice"]["super_blocks"])
                     * self.ratio)
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
        self.kept = [((base + i) * self.B, slots[q]) for i, q in slot.items()]
        return {"attempted": n, "failed": self.failed, "latency_s": lat,
                "late_s": late, "period_s": self.period}

    def stream(self, start: int, length: int) -> torch.Tensor:
        """Samples ``[start, start + length)`` of the input stream on the
        device, ``[C, length]``, zeros before its first sample."""
        parts, t = [], start
        while t < start + length:
            j, off = divmod(t, self.B)
            m = min(self.B - off, start + length - t)
            parts.append(torch.zeros((self.C, m)) if j < 0 else
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

