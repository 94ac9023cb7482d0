"""A tiny matrix configuration (4 inputs mixed to 2 outputs) under a
filter-exchange schedule, run whole on the CPU: sound, it comes out
correct with exchange blocks and the blocks after them among those
compared, and its TF32 control does not; an engine that ignores an
exchange, applies it a block late, swaps with no fade or writes output 1
into output 0 comes out not correct.  The pool of sets goes through the
adapter's ``prepare`` once, in set-up, and the timed exchange gets what it
made.  The two-level engine's reference refuses an exchange block, and a
cell whose reference states no exchange law or whose driver exchanges
none is refused before its engine is built."""

import time

import pytest
import torch

from cardbench.core.cell import run_cell

CELL = "mtiny_live"
SEED = 2 ** 35 + 19


def _run(bench, cell=CELL, seed=SEED, control=False, seconds=0.6,
         device="cpu"):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as run.py does
    try:
        return run_cell(bench, cell, seed, seconds, False, device=device,
                        t_process=time.perf_counter(), log=lambda line: None,
                        control=control)
    finally:
        torch.set_num_threads(threads)


def _spy_driver(bench, monkeypatch):
    """The live driver's class, replaced by one that notes each instance."""
    mod = bench.driver("paced_blocks")
    made = []

    class Spy(mod.Driver):
        def __init__(self, run):
            super().__init__(run)
            made.append(self)

    monkeypatch.setattr(mod, "Driver", Spy)
    return made


def test_the_matrix_cell_under_exchange_is_correct_and_its_control_is_not(
        matrix_bench, monkeypatch):
    made = _spy_driver(matrix_bench, monkeypatch)
    result, checks, control = _run(matrix_bench, control=True)
    assert result["correct"] and checks.correct, checks.lines()
    assert result["failed"] == 0 and result["attempted"] > 100
    err = checks.items["worst_rel_err"]
    assert err["value"] < err["limit"] / 10
    assert not control.correct and not control.items["worst_rel_err"]["ok"]
    assert set(result["metrics"]) == {"block_ms_p99.mtiny", "setup_s"}
    (drv,) = made
    B = drv.B
    sets = {start: s for start, _, s in drv.kept}
    exchanges = [t for t, (a, b) in sets.items() if a != b]
    for t in exchanges:
        a, b = sets[t]
        assert t // B % 8 == 0 and b == (a + 1) % 3
    # a quarter of the 16 drawn blocks are exchange blocks, each with the
    # block right after it, on the set it faded to
    after = [t for t in exchanges if sets.get(t + B) == (sets[t][1],) * 2]
    assert len(after) >= 4
    assert sum(a == b for a, b in sets.values()) >= 8
    for _, y, _ in drv.kept:
        assert y.shape == (2, B)


def test_the_sets_are_prepared_in_set_up_and_the_window_exchanges_them(
        matrix_bench, monkeypatch):
    """``prepare`` runs once a set, before the window; each timed
    ``exchange`` is handed one of the objects it returned, never a set of
    the harness's, so no copy of a set falls in a block's latency."""
    mod = matrix_bench.engine("matrix")
    made = _spy_driver(matrix_bench, monkeypatch)
    calls = []

    class Spy(mod.Engine):
        def prepare(self, filters):
            calls.append(("prepare", filters))
            return super().prepare(filters)

        def exchange(self, prepared):
            calls.append(("exchange", prepared))
            super().exchange(prepared)

    monkeypatch.setattr(mod, "Engine", Spy)
    result, checks, _ = _run(matrix_bench)
    assert result["correct"], checks.lines()
    (drv,) = made
    kinds = [k for k, _ in calls]
    n = len(drv.run.filters)
    assert n == 3 and kinds[:n] == ["prepare"] * n
    assert "prepare" not in kinds[n:] and kinds.count("exchange") > 8
    assert all(f is g for (_, f), g in zip(calls, drv.run.filters))
    ids = {id(p) for p in drv.prepared}
    for _, obj in calls[n:]:
        assert id(obj) in ids and not isinstance(obj, torch.Tensor)


def _faulty(base, fault):
    class Faulty(base):
        def exchange(self, prepared):
            if fault == "ignored":
                return
            if fault == "late":
                self.held = prepared
                return
            super().exchange(prepared)
            if fault == "no_fade":
                c = self.conv
                c.H, c._pending_H = c._pending_H, None

        def live(self, x):
            if fault == "late":
                armed = getattr(self, "armed", None)
                if armed is not None:
                    super().exchange(armed)
                self.armed, self.held = getattr(self, "held", None), None
            y = super().live(x)
            if fault == "ear_1_into_ear_0":
                y = y.clone()
                y[0] = y[1]
            return y

    return Faulty


@pytest.mark.parametrize("fault", ["ignored", "late", "no_fade",
                                   "ear_1_into_ear_0"])
def test_a_broken_exchange_path_is_not_correct(matrix_bench, fault,
                                               monkeypatch):
    mod = matrix_bench.engine("matrix")
    monkeypatch.setattr(mod, "Engine", _faulty(mod.Engine, fault))
    result, checks, _ = _run(matrix_bench)
    assert not result["correct"] and result["failed"] == 0
    err = checks.items["worst_rel_err"]
    assert not err["ok"] and err["value"] > err["limit"], checks.lines()


@pytest.mark.card
def test_the_matrix_cell_under_exchange_holds_on_the_card(matrix_bench,
                                                          card):
    """On the card, with the port's kernels: correct, no plain call, and
    the control not correct; each broken exchange path not correct."""
    result, checks, control = _run(matrix_bench, control=True, seconds=2.0,
                                   device=card)
    assert result["correct"] and checks.correct, checks.lines()
    assert checks.items["plain_calls"]["value"] == 0
    assert result["device"]["platform"] == "gpu"
    assert not control.correct and not control.items["worst_rel_err"]["ok"]
    mod = matrix_bench.engine("matrix")
    base = mod.Engine
    try:
        for fault in ("ignored", "late", "no_fade", "ear_1_into_ear_0"):
            mod.Engine = _faulty(base, fault)
            result, checks, _ = _run(matrix_bench, seconds=1.0, device=card)
            assert not result["correct"], fault
            assert not checks.items["worst_rel_err"]["ok"], fault
    finally:
        mod.Engine = base


def test_the_two_level_reference_refuses_an_exchange_block():
    from cardbench.reference import nonuniform as ref

    g = torch.Generator().manual_seed(3)
    x, h, h2 = (torch.randn(2, 64, generator=g),
                torch.randn(2, 16, generator=g),
                torch.randn(2, 16, generator=g))
    assert ref.outputs(x, h, 8).shape == (2, 8)
    for precision in ("float64", "tf32"):
        with pytest.raises(ValueError, match="exchange law"):
            ref.outputs(x, h, 8, before=h2, precision=precision)


def _no_engine(bench, monkeypatch, engine):
    """The adapter's class, replaced by one that notes each instance."""
    mod = bench.engine(engine)
    built = []

    class Noted(mod.Engine):
        def __init__(self, *args, **kwargs):
            built.append(self)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(mod, "Engine", Noted)
    return built


def test_a_two_level_cell_under_an_exchange_schedule_is_refused(
        tiny_bench, monkeypatch):
    """The tiny two-level configuration on an exchanging mix: its
    reference states no exchange law, so the run is refused before the
    engine is built or the window runs."""
    live = tiny_bench.traffic("live_tiny")
    live["exchange"] = {"every_blocks": 8, "sets": 2}
    monkeypatch.setattr(tiny_bench, "traffic", lambda name: live)
    built = _no_engine(tiny_bench, monkeypatch, "nonuniform")
    with pytest.raises(ValueError, match="states no exchange law"):
        _run(tiny_bench, "tiny_live")
    assert built == []


def test_the_render_loop_refuses_an_exchanging_mix(tiny_bench, monkeypatch):
    render = tiny_bench.traffic("render_tiny")
    render["exchange"] = {"every_blocks": 8, "sets": 2}
    monkeypatch.setattr(tiny_bench, "traffic", lambda name: render)
    built = _no_engine(tiny_bench, monkeypatch, "nonuniform")
    with pytest.raises(ValueError, match="exchanges no filters"):
        _run(tiny_bench, "tiny_render")
    assert built == []


@pytest.mark.parametrize("exchange", [{"every_blocks": 0, "sets": 3},
                                      {"every_blocks": 8, "sets": 1}])
def test_an_exchange_schedule_with_nothing_to_exchange_is_refused(
        matrix_bench, monkeypatch, exchange):
    live = dict(matrix_bench.traffic("live_exchange_tiny"), exchange=exchange)
    monkeypatch.setattr(matrix_bench, "traffic", lambda name: live)
    built = _no_engine(matrix_bench, monkeypatch, "matrix")
    with pytest.raises(ValueError, match="two filter sets or more"):
        _run(matrix_bench)
    assert built == []
