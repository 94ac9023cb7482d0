"""A whole run at a tiny size on the CPU, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, in
each way these cells can break, it comes out not correct; and the control
(the reference in TF32 in the program's place), judged by the same checks,
comes out not correct.

The faults: a step that returns its state unchanged; half of the channels
(the batch) left out; an answer altered where it is produced.  The
exchange between chips does not exist on one card."""

import contextlib
import time

import pytest
import torch

from cardbench.core.cell import run_cell

CELLS = ("tiny_render", "tiny_live")
SECONDS = {"tiny_render": 1.0, "tiny_live": 0.6}


def _run(bench, cell, seed=2 ** 33 + 11, control=False):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as run.py does
    try:
        return run_cell(bench, cell, seed, SECONDS[cell], False,
                        device="cpu", t_process=time.perf_counter(),
                        log=lambda line: None, control=control)
    finally:
        torch.set_num_threads(threads)


def _faulty(base, fault):
    class Faulty(base):
        def _wrap(self, y, before):
            c = self.conv
            if fault == "state_unchanged":
                c.state, c._sb_fill, c._sb_buf = before
            elif fault == "half_batch":
                y = y.clone()
                y[y.shape[0] // 2:] = 0
            elif fault == "answer_altered":
                y = y.clone()
                y[0, 0] += 1.0
            return y

        def _before(self):
            c = self.conv
            return c.state, c._sb_fill, c._sb_buf.clone()

        def render(self, x):
            before = self._before()
            return self._wrap(super().render(x), before)

        def live(self, x):
            before = self._before()
            return self._wrap(super().live(x), before)

    return Faulty


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(tiny_bench, cell):
    result, checks, control = _run(tiny_bench, cell, control=True)
    assert result["correct"] and checks.correct, checks.lines()
    assert result["failed"] == 0 and result["attempted"] > 10
    err = checks.items["worst_rel_err"]
    assert err["value"] < err["limit"] / 10
    assert not control.correct, control.lines()
    assert not control.items["worst_rel_err"]["ok"]
    assert control.items["worst_rel_err"]["limit"] == err["limit"]
    assert set(control.items) >= {"worst_rel_err", "failed_calls",
                                  "compared_outputs"}
    assert checks.items["compared_outputs"]["value"] >= 9
    assert set(result["metrics"]) == {
        "tiny_render": {"rtf.tiny", "setup_s"},
        "tiny_live": {"block_ms_p99.tiny", "setup_s"}}[cell]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell, fault,
                                            monkeypatch):
    mod = tiny_bench.engine("nonuniform")
    monkeypatch.setattr(mod, "Engine", _faulty(mod.Engine, fault))
    result, checks, control = _run(tiny_bench, cell)
    assert control is None and not result["correct"]
    assert not checks.items["worst_rel_err"]["ok"]


def test_a_call_that_raises_is_counted_and_not_correct(tiny_bench,
                                                       monkeypatch):
    mod = tiny_bench.engine("nonuniform")

    class Raising(mod.Engine):
        n = 0

        def render(self, x):
            Raising.n += 1
            if Raising.n == 6:
                raise RuntimeError("a launch failed")
            return super().render(x)

    monkeypatch.setattr(mod, "Engine", Raising)
    result, checks, _ = _run(tiny_bench, "tiny_render")
    assert result["failed"] >= 1 and not result["correct"]


def test_the_traced_run_reads_its_slice_and_stays_correct(tiny_bench):
    result, checks, _ = run_cell(tiny_bench, "tiny_live", 5, 0.5, True,
                                 device="cpu", t_process=time.perf_counter(),
                                 log=lambda line: None)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    # no device here: the whole slice is idle, split by the host's ops
    idle = dict(result["breakdown"]["idle_gaps"])
    assert 0 < len(idle) <= 10 and min(idle.values()) > 0
    assert sum(idle.values()) <= result["device"]["window_s"] * (1 + 1e-9)
    assert result["breakdown"]["device_ops"] == []
    # and the per-layer readers find nothing to read and stay silent
    assert result["metrics"] == {}


class _Doubling:
    """A stand-in engine: each render call doubles its input."""
    group_samples = 8

    def render(self, x):
        return x * 2


class _SliceSpy:
    """A stand-in tracer that notes the driver's call index at the slice's
    start and stop."""

    def __init__(self, drv):
        self.drv, self.at = drv, []

    def start(self):
        self.at.append(self.drv.k)

    def stop(self, units):
        self.at.append(self.drv.k)

    def span(self):
        return contextlib.nullcontext()


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 7])
def test_the_render_slice_opens_on_a_full_reservoir_and_holds_no_sample(
        seed):
    import json

    from cardbench.core.cell import Run
    from cardbench.drivers import render_loop

    from conftest import ROOT

    tr = json.loads((ROOT / "cardbench/traffic/render.json").read_text())
    tr.update(pool_min_bytes=0, warmup_calls=2,
              trace_slice={"seconds": 0.01, "min_calls": 20,
                           "max_calls": 40})
    run = Run({"channels": 2, "signal_rms": 0.1, "sample_rate": 48000},
              tr, seed, torch.device("cpu"), _Doubling())
    drv = render_loop.Driver(run)
    drv.setup()
    base = drv.k
    spy = _SliceSpy(drv)
    record = drv.window(0.3, spy)
    start, stop = spy.at
    assert start - base == tr["keep"]
    assert stop - start >= 20 and record["attempted"] > stop - base
    sampled = [s // drv.G for s, _, _ in drv.kept]
    assert len(sampled) == tr["keep"] + 1
    assert not [k for k in sampled if start <= k < stop]
    for s, y, sets in drv.kept:
        assert torch.equal(y, 2 * drv.stream(s, drv.G)) and sets == (0, 0)
