"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line's fields.

:func:`run_cell` is ``run.py``'s body without its look for a card, so the
tests can drive a whole run on the CPU at a small size.

The configuration's reference module (``reference/<engine>.py``) makes
its filters and says how many past samples an output depends on
(``memory``).  A configuration may give ``inputs`` and ``outputs`` where
they differ; both default to ``channels``.  A traffic mix may give
``exchange: {"every_blocks": k, "sets": n}`` where its driver exchanges
(``EXCHANGES``) and the reference states an exchange law
(``EXCHANGE_LAW``), else the run is refused before anything is built:
set-up makes ``n`` filter sets from the tags ``ir``, ``ir1``, ... of the
seed, and the driver exchanges to the next at every ``k``-th block.  Each
compared output comes with the sets active before and after it, and the
reference computes it from the filters and the history alone.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from cardbench.core import seeds, verdict
from cardbench.core.trace import Tracer

__all__ = ["Run", "Context", "run_cell"]


@dataclass
class Run:
    """What a driver is given: the cell's files, the seed, the device and
    the engine under test."""
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    engine: object = None
    memory: int = 0
    filters: list = field(default_factory=list)

    @property
    def inputs(self) -> int:
        return int(self.cfg.get("inputs", self.cfg.get("channels")))

    @property
    def outputs(self) -> int:
        return int(self.cfg.get("outputs", self.cfg.get("channels")))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Context:
    """What a metric reader (``metrics/<name>.py``) is given."""
    bench: object
    setup_s: float
    window: dict
    slice: object = None
    shapes: dict = field(default_factory=dict)
    kernel_functions: dict = field(default_factory=dict)


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def _checks(cfg, worst, failed, compared, plain) -> verdict.Checks:
    """The numbers that decide ``correct``, each beside its limit."""
    checks = verdict.Checks()
    checks.at_most("worst_rel_err", worst, verdict.limit(cfg))
    checks.at_most("failed_calls", failed, 0)
    checks.at_least("compared_outputs", compared, 2)
    if plain is not None:
        checks.at_most("plain_calls", plain, 0)
    return checks


def _filter_sets(tr: dict, reference, drivers) -> int:
    """How many filter sets the mix needs: 1, or its exchange's ``sets``
    where the driver and the reference both take an exchange."""
    ex = tr.get("exchange")
    if ex is None:
        return 1
    if not getattr(drivers, "EXCHANGES", False):
        raise ValueError(f"{drivers.__name__} exchanges no filters")
    if not getattr(reference, "EXCHANGE_LAW", False):
        raise ValueError(f"{reference.__name__} states no exchange law")
    if int(ex["every_blocks"]) < 1 or int(ex["sets"]) < 2:
        raise ValueError(f"exchange {ex}: every_blocks >= 1 and two filter "
                         f"sets or more")
    return int(ex["sets"])


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, *,
             device, t_process: float, log=print, control: bool = False):
    """Run cell ``name`` once; returns ``(result, checks, control)``: the
    result line's dict without ``checks``, the :class:`~verdict.Checks` of
    the program's outputs, and, with ``control`` set, the same checks of
    the control's outputs (the reference in TF32, put in the program's
    place, on the same compared outputs), else ``None``."""
    device = torch.device(device)
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    reference = bench.reference(cfg["engine"])
    drivers = bench.driver(tr["driver"])
    wanted = bench.per_layer_for(name) if trace else bench.end_to_end_for(name)
    readers = {m["name"]: bench.reader(m["name"]) for m in wanted}
    sets = _filter_sets(tr, reference, drivers)

    # ---- set-up: inputs from the seed, the engine, warm-up ----------------
    stamps = [("process start to the cell's files", t_process,
               time.perf_counter())]

    def done(what):
        run.sync()
        stamps.append((what, stamps[-1][2], time.perf_counter()))

    run = Run(cfg, tr, seed, device, memory=reference.memory(cfg))
    run.filters = [reference.filters(cfg, seeds.generator(seed, tag, device),
                                     device)
                   for tag in ["ir"] + [f"ir{k}" for k in range(1, sets)]]
    done("the IRs on the card")
    run.engine = bench.engine(cfg["engine"]).Engine(cfg, run.filters[0],
                                                    device)
    done("the engine (its constructor)")
    drv = drivers.Driver(run)
    drv.setup()
    done("the traffic's inputs and warm-up")
    tracer = None
    if trace:
        tracer = Tracer(device, drv.span, run.engine.counts)
        tracer.warm(drv.warm_call)
        done("the profiler's first start")
    counts0 = run.engine.counts()
    shapes = run.engine.shapes(tr["entry"])
    gc.collect()
    gc.freeze()          # set-up's objects out of the collector's way
    run.sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_process

    # ---- the window ---------------------------------------------------------
    record = drv.window(seconds, tracer)
    dev_info = _device_info(device)
    if tracer is not None:
        tracer.read()
    counts = run.engine.counts()
    gc.unfreeze()

    # ---- the comparison, once the program's state is freed ------------------
    run.engine = None
    kept = drv.kept
    M = run.memory
    worst, worst_ctl, failed_ctl = 0.0, 0.0, 0
    for start, y, (before, after) in kept:
        n = y.shape[-1]
        hist = drv.stream(start - M, M + n)
        law = {} if before == after else {"before": run.filters[before]}
        ref = reference.outputs(hist, run.filters[after], n, **law)
        worst = max(worst, verdict.rel_err(y, ref))
        if control:
            ctl = reference.outputs(hist, run.filters[after], n,
                                    precision="tf32", **law)
            worst_ctl = max(worst_ctl, verdict.rel_err(ctl, ref))
            failed_ctl += not bool(torch.isfinite(ctl).all())
            del ctl
        del hist, ref
    failed = int(record["failed"])
    plain = None
    if device.type == "cuda":
        plain = sum(counts["plain"].values()) - sum(counts0["plain"].values())
    checks = _checks(cfg, worst, failed, len(kept), plain)
    # the control stands in the program's place: its outputs face the
    # same checks, and have to come out not correct
    ctl_checks = (_checks(cfg, worst_ctl, failed_ctl, len(kept), None)
                  if control else None)
    log("set-up: " + ", ".join(f"{what} {b - a:.4f} s"
                               for what, a, b in stamps))
    for line in drv.info():
        log(line)
    ran = {k: v - counts0["launches"].get(k, 0)
           for k, v in counts["launches"].items()
           if v - counts0["launches"].get(k, 0)}
    log(f"program counters over the window: launches {ran}")

    # ---- metrics ------------------------------------------------------------
    ctx = Context(bench, setup_s, record,
                  tracer.slice if tracer else None, shapes,
                  bench.kernel_functions())
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            log(f"{m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": checks.correct, "attempted": int(record["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if tracer is not None:
        sl = tracer.slice
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.span_s
        result["breakdown"] = sl.breakdown()
        fn = ctx.kernel_functions
        loose = sorted({n for n, _ in sl.kernels if n not in fn})
        log(f"trace slice: {sl.units} units over {sl.span_s:.6f} s, device "
            f"busy {sl.busy_s:.6f} s, {len(sl.kernels)} kernel launches")
        log(f"kernels that map to no function: {loose}")
    return result, checks, ctl_checks
