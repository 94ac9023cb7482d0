"""The contract between the cell, its drivers, its engine adapter and its
reference module keeps every two-level input, compared block and traced
slice as the formulas that fixed them before it: the filters come from
the reference module byte for byte as ``signals.room_irs`` made them, the
live driver picks the blocks and the slice that the IR's length and the
engine's ``ratio`` picked, the render loop its reservoir of calls, and a
configuration that gives no ``inputs`` or ``outputs`` runs as before."""

import contextlib
import json
import math

import pytest
import torch

from cardbench.core import manifest, seeds, signals
from cardbench.core.cell import Run
from cardbench.reference import nonuniform as ref

from conftest import DATA, ROOT

SEED = 2 ** 33 + 77


def _cfg(name):
    if name == "tiny":
        return json.loads((DATA / "tiny.json").read_text())
    return json.loads((ROOT / f"cardbench/configs/{name}.json").read_text())


def _traffic(name):
    return json.loads((ROOT / f"cardbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("name", ["tiny", "hoa64_32k", "pod1024_64k"])
def test_the_reference_makes_the_irs_byte_for_byte_as_before(name):
    cfg = _cfg(name)
    got = ref.filters(cfg, seeds.generator(SEED, "ir", "cpu"), "cpu")
    want = signals.room_irs(cfg["channels"], cfg["ir_taps"], cfg["ir_rt60_s"],
                            cfg["sample_rate"],
                            seeds.generator(SEED, "ir", "cpu"), "cpu")
    assert got.dtype == torch.float32
    assert got.shape == (cfg["channels"], cfg["ir_taps"])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert ref.memory(cfg) == cfg["ir_taps"] - 1


def _parent_plan(seed, n, base, ir_taps, B, ratio, keep, super_blocks,
                 traced):
    """The live window's compared blocks and traced slice as the two-level
    engine's attributes fixed them before the contract took them over."""
    first = max(0, math.ceil(ir_taps / B) + ratio - base)
    pick = list(range(first, n - 1))
    rng = seeds.host_rng(seed, "keep")
    idx = sorted(rng.sample(pick, min(keep, len(pick))))
    idx.append(n - 1)
    s0 = s1 = -1
    if traced:
        s0 = next(i for i in range(min(8, n - 1), n)
                  if (base + i) % ratio == 0)
        s1 = min(n, s0 + super_blocks * ratio)
    return idx, (s0, s1)


class _Shape:
    """A stand-in engine with a two-level engine's live attributes."""

    def __init__(self, cfg):
        self.block, self.cycle_blocks = cfg["block"], cfg["ratio"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 40 + 3])
@pytest.mark.parametrize("name, seconds", [("tiny", 0.6), ("tiny", 0.2),
                                           ("pod1024_64k", 51),
                                           ("pod1024_64k", 2)])
def test_the_live_driver_picks_the_blocks_and_slice_it_picked_before(
        name, seconds, seed, traced):
    from cardbench.drivers import paced_blocks

    cfg, tr = _cfg(name), _traffic("live")
    run = Run(cfg, tr, seed, torch.device("cpu"), _Shape(cfg),
              memory=ref.memory(cfg))
    drv = paced_blocks.Driver(run)
    B, ratio = cfg["block"], cfg["ratio"]
    n = max(1, round(seconds / (B / cfg["sample_rate"])))
    for base in (0, 16, 16 + 3, 16 + 8 * 5 + 1):
        got = drv.plan(n, base, traced)
        want = _parent_plan(seed, n, base, cfg["ir_taps"], B, ratio,
                            tr["keep"], tr["trace_slice"]["super_blocks"],
                            traced)
        assert got == want
        assert [drv.sets(base + i) for i in got[0]] == [(0, 0)] * len(got[0])


def test_the_two_level_adapter_gives_its_ratio_as_its_cycle():
    cfg = _cfg("tiny")
    bench = manifest.load()
    ir = ref.filters(cfg, seeds.generator(SEED, "ir", "cpu"), "cpu")
    eng = bench.engine("nonuniform").Engine(cfg, ir, "cpu")
    assert eng.cycle_blocks == eng.conv.ratio == cfg["ratio"]
    assert eng.block == cfg["block"]


class _Doubling:
    group_samples = 8

    def render(self, x):
        return x * 2


class _SliceSpy:
    def __init__(self, drv):
        self.drv, self.at = drv, []

    def start(self):
        self.at.append(self.drv.k)

    def stop(self, units):
        self.at.append(self.drv.k)

    def span(self):
        return contextlib.nullcontext()


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("seed", [4, 2 ** 36 + 9])
def test_the_render_loop_keeps_the_reservoir_it_kept_before(seed, traced):
    """The render loop's compared calls are the reservoir sample of every
    call drawn (none of the traced slice's), and the last call."""
    from cardbench.drivers import render_loop

    tr = _traffic("render")
    tr.update(pool_min_bytes=0, warmup_calls=2,
              trace_slice={"seconds": 0.01, "min_calls": 20,
                           "max_calls": 40})
    run = Run({"channels": 2, "signal_rms": 0.1, "sample_rate": 48000},
              tr, seed, torch.device("cpu"), _Doubling())
    drv = render_loop.Driver(run)
    drv.setup()
    base = drv.k
    spy = _SliceSpy(drv) if traced else None
    record = drv.window(0.2, spy)
    # the calls open to the draw, in order: all but the slice's
    lo, hi = spy.at if traced else (drv.k, drv.k)
    drawn = [k for k in range(base, base + record["attempted"])
             if not lo <= k < hi]
    rng = seeds.host_rng(seed, "keep")
    slot = [None] * tr["keep"]
    for d, k in enumerate(drawn):
        j = d if d < tr["keep"] else rng.randrange(d + 1)
        if j < tr["keep"]:
            slot[j] = k
    want = [k * drv.G for k in slot if k is not None]
    last = base + record["attempted"] - 1
    if last not in slot:
        want.append(last * drv.G)
    assert [s for s, _, _ in drv.kept] == want
    assert all(sets == (0, 0) for _, _, sets in drv.kept)


@pytest.mark.parametrize("driver, traffic", [("paced_blocks", "live"),
                                             ("render_loop", "render")])
def test_a_configuration_without_inputs_or_outputs_runs_as_before(
        driver, traffic):
    """The input pool is the noise the drivers made from ``channels``, byte
    for byte, and a configuration that states ``inputs`` and ``outputs``
    equal to ``channels`` compares the same blocks with the same bytes."""
    cfg = _cfg("tiny")
    tr = _traffic(traffic)
    tr.update(json.loads((DATA / f"{traffic}_tiny.json").read_text()))
    bench = manifest.load()
    mod = bench.driver(driver)
    kept = []
    for c in (cfg, dict(cfg, inputs=cfg["channels"],
                        outputs=cfg["channels"])):
        ir = ref.filters(c, seeds.generator(SEED, "ir", "cpu"), "cpu")
        run = Run(c, tr, SEED, torch.device("cpu"),
                  bench.engine("nonuniform").Engine(c, ir, "cpu"),
                  memory=ref.memory(c), filters=[ir])
        assert run.inputs == run.outputs == cfg["channels"]
        drv = mod.Driver(run)
        drv.setup()
        C = cfg["channels"]
        if driver == "paced_blocks":
            n = tr["input_pool_blocks"]
            shape = (n, C, cfg["block"])
        else:
            shape = tuple(drv.pool.shape)
            assert shape[1:] == (C, drv.G)
        want = signals.noise(shape, cfg["signal_rms"],
                             seeds.generator(SEED, "pool", "cpu"), "cpu")
        assert torch.equal(drv.pool, want)
        drv.window(0.3 if driver == "paced_blocks" else 0.5)
        for start, y, sets in drv.kept:
            assert y.shape[0] == C and sets == (0, 0)
        kept.append(drv.kept)
    if driver == "paced_blocks":        # the same blocks, the same bytes
        assert [s for s, _, _ in kept[0]] == [s for s, _, _ in kept[1]]
        for (_, a, _), (_, b, _) in zip(*kept):
            assert torch.equal(a, b)
