"""``render``: a closed loop of ``process`` calls, one render group each,
back to back on one continuing stream.

Inputs and outputs stay on the card, as in a GPU stage of a render
pipeline.  Call k renders chunk ``order[k % n]`` of a pool made on the
card from the seed; the pool is larger than the traffic's
``pool_min_bytes`` (4x the card's 50 MB L2) and holds at least
``pool_min_chunks`` chunks, so no call finds its input in the L2.  The
window synchronises once, at its end, so host gaps count.

Outputs compared: a reservoir sample of ``keep`` calls of the window,
drawn from the seed and copied aside as they are produced, and the last;
a call fails if it raises or if its output, where sampled, is not
finite (checking every output would add a launch to every call).

With a tracer, the traced slice opens once the reservoir is full and its
calls are not drawn, so none of the harness's copies falls inside it.

It exchanges no filters (``EXCHANGES``): a render call has no exchange
block to fade over.
"""

from __future__ import annotations

import contextlib
import math
import time
import traceback

import torch

from cardbench.core import seeds, signals

__all__ = ["EXCHANGES", "Driver"]

EXCHANGES = False
_NULL = contextlib.nullcontext()


class Driver:
    span = "cardbench.render"

    def __init__(self, run):
        self.run = run
        self.G = run.engine.group_samples
        self.k = 0                    # global call index, warm-up included
        self.failed = 0
        self.kept = []

    def _x(self, k: int) -> torch.Tensor:
        return self.pool[self.order[k % len(self.order)]]

    def _call(self):
        y = self.run.engine.render(self._x(self.k))
        self.k += 1
        return y

    def setup(self) -> None:
        run, tr = self.run, self.run.traffic
        chunk = 4 * run.inputs * self.G
        n = max(int(tr["pool_min_chunks"]),
                math.ceil(tr["pool_min_bytes"] / chunk))
        self.pool = signals.noise(
            (n, run.inputs, self.G), run.cfg["signal_rms"],
            seeds.generator(run.seed, "pool", run.device), run.device)
        self.order = list(range(n))
        seeds.host_rng(run.seed, "order").shuffle(self.order)
        y = None
        for _ in range(int(tr["warmup_calls"])):
            y = self._call()          # two outputs alive, as in the window
        del y
        self.slots = torch.empty((int(tr["keep"]), run.outputs, self.G),
                                 device=run.device)
        run.sync()

    def warm_call(self) -> None:
        self._call()

    def window(self, seconds: float, tracer=None) -> dict:
        run, tr = self.run, self.run.traffic
        keep = self.slots.shape[0]
        rng = seeds.host_rng(run.seed, "keep")
        slot_call = [None] * keep
        cut = tr["trace_slice"]
        seen, drawn, last = 0, 0, None    # calls; calls open to the draw
        to_trace = tracer is not None
        in_slice, slice_n, slice_t0 = False, 0, 0.0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            now = time.perf_counter()
            if to_trace and (drawn >= keep or now >= t_end):
                tracer.start()
                to_trace, in_slice = False, True
                slice_t0 = time.perf_counter()
            elif in_slice and (slice_n >= cut["max_calls"] or (
                    slice_n >= cut["min_calls"]
                    and now - slice_t0 >= cut["seconds"])):
                tracer.stop(units=slice_n)
                in_slice = False
            elif now >= t_end:
                break
            k = self.k
            try:
                with (tracer.span() if in_slice else _NULL):
                    y = self._call()
            except Exception:
                if not self.failed:
                    traceback.print_exc()
                self.failed += 1
                self.k = k + 1
                seen += 1
                continue
            seen += 1
            last = (k, y)
            if in_slice:
                slice_n += 1
                continue
            j = drawn if drawn < keep else rng.randrange(drawn + 1)
            if j < keep:
                self.slots[j].copy_(y)
                slot_call[j] = k
            drawn += 1
        run.sync()
        wall = time.perf_counter() - t0
        self.kept = [(k * self.G, self.slots[j], (0, 0))
                     for j, k in enumerate(slot_call) if k is not None]
        if last is not None and last[0] not in slot_call:
            self.kept.append((last[0] * self.G, last[1], (0, 0)))
        # a call whose output is not finite failed; the sample is read
        self.failed += sum(not bool(torch.isfinite(y).all())
                           for _, y, _ in self.kept)
        return {"attempted": seen, "failed": self.failed,
                "audio_s": seen * self.G / run.cfg["sample_rate"],
                "wall_s": wall}

    def stream(self, start: int, length: int) -> torch.Tensor:
        """Samples ``[start, start + length)`` of the input stream,
        ``[inputs, length]``, zeros before the stream's first sample."""
        parts, t = [], start
        while t < start + length:
            k, off = divmod(t, self.G)
            n = min(self.G - off, start + length - t)
            parts.append(torch.zeros((self.run.inputs, n),
                                     device=self.run.device)
                         if k < 0 else self._x(k)[:, off:off + n])
            t += n
        return torch.cat(parts, dim=1)

    def info(self) -> list[str]:
        return [f"render: {self.k} calls in all, a group of {self.G} samples, "
                f"a pool of {len(self.order)} chunks "
                f"({self.pool.numel() * 4 / 1e6:.1f} MB)"]

