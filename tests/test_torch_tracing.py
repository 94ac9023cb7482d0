"""The port's spans and their tallies (``utils/profiling.py``).

With no profiler running a span is the one shared null context and the
engine leaves every tally as it was.  Under ``torch.profiler`` a small
two-level engine, one super-block of small blocks and one ``process``
call, gives exact calls for the five engine spans and for each
``ops_hook.<kernel>`` span (as many as the kernel's plain calls), host
self time within host time, each span as a ``user_annotation`` inside its
parent's interval in the chrome trace, and outputs bit-identical to an
untraced run.  The device extent is driven with stand-in CUDA events: the
CPU has none.
"""

import json
import time

import numpy as np
import pytest
import torch

from bbcat_dsp_torch import NonUniformConvolver, ops_hook
from bbcat_dsp_torch.convolve import nonuniform
from bbcat_dsp_torch.ops.kernels import _build
from bbcat_dsp_torch.utils import profiling
from bbcat_dsp_torch.utils.profiling import SPANS, named_scope, span, tallies

B, RATIO = 64, 4
SB = B * RATIO
PT = 3                                   # tail partitions
N = 2 * SB + PT * SB                     # head 2 * ratio blocks, then the tail
KERNELS = ("fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
           "gather_supers", "delayed_add", "head_mac", "rotated_mac",
           "xt_step_mac")
ENGINE_CALLS = {"nonuniform.small_block": RATIO, "nonuniform.input": RATIO,
                "nonuniform.head_step": RATIO, "nonuniform.tail_step": 1,
                "nonuniform.process": 1}
# the engine spans whose device extent a metric reads
EXTENT_READ = ("nonuniform.process", "nonuniform.tail_step")
# the span each span runs inside, in this run
PARENTS = {"nonuniform.input": ("nonuniform.small_block",),
           "nonuniform.head_step": ("nonuniform.small_block",),
           "nonuniform.tail_step": ("nonuniform.small_block",),
           **{f"ops_hook.{k}": ("nonuniform.head_step", "nonuniform.tail_step",
                                "nonuniform.process") for k in KERNELS}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine():
    rng = np.random.default_rng(18)
    ir = rng.standard_normal((2, N)) * np.exp(-np.arange(N) / 300.0)
    conv = NonUniformConvolver(ir, B, RATIO, device="cpu")
    assert conv.tail_parts == PT
    return conv


def _inputs():
    g = torch.Generator().manual_seed(18)
    blocks = [torch.randn(2, B, generator=g) for _ in range(RATIO)]
    return blocks, torch.randn(2, PT * SB, generator=g)


def _drive(conv):
    """One super-block of small blocks, then one render group."""
    blocks, group = _inputs()
    ys = [conv.process_small_block(x) for x in blocks]
    return ys + [conv.process(group)]


def _plain_by_kernel(plain):
    """``counts()["plain"]`` with K9's three types summed under its span's
    name."""
    out = {k: plain.get(k, 0) for k in KERNELS}
    out["rotated_mac"] = sum(v for k, v in plain.items()
                             if k.startswith("rotated_mac"))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The run under the profiler: its tallies, counts, chrome trace events
    and outputs."""
    conv = _engine()
    ops_hook.reset_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ys = _drive(conv)
    counts = ops_hook.counts()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ops_hook.reset_counts()
    return {"counts": counts, "events": events, "ys": ys}


@pytest.fixture(scope="module")
def untraced():
    conv = _engine()
    ops_hook.reset_counts()
    ys = _drive(conv)
    counts = ops_hook.counts()
    ops_hook.reset_counts()
    return {"counts": counts, "ys": ys}


# ---- with no profiler ----------------------------------------------------

@pytest.mark.parametrize("name", SPANS)
def test_without_a_profiler_a_span_is_the_shared_null_context(name):
    assert not torch.autograd._profiler_enabled()
    assert span(name) is profiling._NULL
    assert span(name, torch.device("cuda", 0)) is profiling._NULL


def test_without_a_profiler_the_engine_leaves_every_tally_unchanged(
        untraced):
    zero = {"calls": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
            "pending": 0}
    assert untraced["counts"]["spans"] == dict.fromkeys(SPANS, zero)


def test_without_a_profiler_named_scope_enters_no_record_function(
        monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)

    @named_scope("nonuniform.process")
    def work(v):
        return v * 3

    assert float(work(torch.ones(1))) == 3.0
    assert tallies()["nonuniform.process"]["calls"] == 0


# ---- under the profiler --------------------------------------------------

@pytest.mark.parametrize("name", list(ENGINE_CALLS))
def test_each_engine_span_counts_its_calls(traced, name):
    assert traced["counts"]["spans"][name]["calls"] == ENGINE_CALLS[name]


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_dispatch_span_counts_as_many_calls_as_its_plain_version(
        traced, kernel):
    plain = _plain_by_kernel(traced["counts"]["plain"])
    assert traced["counts"]["spans"][f"ops_hook.{kernel}"]["calls"] == \
        plain[kernel]
    if kernel != "rotated_mac":                   # the engine never calls K9
        assert plain[kernel] > 0


@pytest.mark.parametrize("name", list(PARENTS) + ["nonuniform.small_block",
                                                  "nonuniform.process"])
def test_self_time_lies_within_host_time(traced, name):
    t = traced["counts"]["spans"][name]
    if name != "ops_hook.rotated_mac":
        assert t["host_s"] > 0
    assert 0 <= t["self_s"] <= t["host_s"]
    # on the CPU a span has no device extent
    assert t["device_s"] == 0 and t["pending"] == 0


@pytest.mark.parametrize("name", [n for n in PARENTS
                                  if n != "ops_hook.rotated_mac"])
def test_the_chrome_trace_nests_each_span_inside_its_parent(traced, name):
    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    mine = [interval(e) for e in traced["events"] if e["name"] == name]
    assert len(mine) == traced["counts"]["spans"][name]["calls"]
    parents = [interval(e) for e in traced["events"]
               if e["name"] in PARENTS[name]]
    for a, b in mine:
        assert any(pa <= a and b <= pb for pa, pb in parents), (name, a, b)


@pytest.mark.parametrize("name", list(ENGINE_CALLS))
def test_only_the_spans_whose_extent_is_read_name_a_device(monkeypatch,
                                                           name):
    """A device extent costs two event records under the profiler, so the
    engine asks for one only where a metric reads it."""
    asked = {}

    def record(span_name, device=None):
        asked.setdefault(span_name, set()).add(device)
        return profiling._NULL

    monkeypatch.setattr(nonuniform, "span", record)
    _drive(_engine())
    want = torch.device("cpu") if name in EXTENT_READ else None
    assert asked[name] == {want}


def test_outputs_are_bit_identical_with_tracing_on_and_off(traced, untraced):
    assert len(traced["ys"]) == len(untraced["ys"]) == RATIO + 1
    for a, b in zip(traced["ys"], untraced["ys"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["launches", "plain", "adjoint"])
def test_the_kernel_counters_are_the_same_with_tracing_on_and_off(
        traced, untraced, entry):
    assert traced["counts"][entry] == untraced["counts"][entry]
    assert set(traced["counts"][entry]) == set(_build.KERNELS)


def test_reset_counts_zeroes_the_tallies():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("nonuniform.process"):
            ops_hook.rfft_half(torch.zeros(2, 8), 16)
    t = ops_hook.counts()["spans"]
    assert t["nonuniform.process"]["calls"] == 1
    assert t["ops_hook.rfft_half"]["calls"] == 1
    ops_hook.reset_counts()
    t = ops_hook.counts()["spans"]
    assert not any(v for tally in t.values() for v in tally.values())


def test_self_time_is_the_span_less_its_children():
    ops_hook.reset_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("nonuniform.small_block"):
            time.sleep(0.01)
            with span("nonuniform.head_step"):
                time.sleep(0.02)
                with span("ops_hook.head_mac"):
                    time.sleep(0.02)
    t = tallies()
    outer, mid, inner = (t[n] for n in ("nonuniform.small_block",
                                        "nonuniform.head_step",
                                        "ops_hook.head_mac"))
    assert inner["self_s"] == inner["host_s"] >= 0.02
    assert mid["host_s"] >= inner["host_s"] + 0.02
    assert mid["self_s"] == pytest.approx(mid["host_s"] - inner["host_s"])
    assert outer["self_s"] == pytest.approx(outer["host_s"] - mid["host_s"])
    assert 0.01 <= outer["self_s"] < outer["host_s"]
    ops_hook.reset_counts()


# ---- the device extent, with stand-in CUDA events ------------------------

class _Event:
    """A stand-in ``torch.cuda.Event``: a record takes the next tick of a
    fake stream clock; ``query`` is true once the test lets the card
    pass it, or every record up to ``upto``."""
    clock = 0.0
    passed = False
    upto = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self, stream=None):
        assert stream == "stream 0"
        _Event.clock += 1.5
        self.t = _Event.clock

    def query(self):
        return _Event.passed or self.t <= _Event.upto

    def elapsed_time(self, other):            # ms, as torch gives it
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a span synchronised")

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda idx=None: f"stream {idx}")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(profiling, "_POOL", {})
    monkeypatch.setattr(profiling, "_PENDING", [])
    _Event.clock, _Event.passed, _Event.upto, _Event.made = 0.0, False, 0.0, 0
    ops_hook.reset_counts()
    yield torch.device("cuda", 0)
    ops_hook.reset_counts()


@pytest.mark.parametrize("name", list(ENGINE_CALLS))
def test_an_engine_span_on_a_card_gives_its_device_extent_once_passed(
        fake_card, name):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with span(name, fake_card):
                pass
    t = tallies()[name]
    assert (t["calls"], t["pending"], t["device_s"]) == (3, 3, 0.0)
    _Event.passed = True
    t = tallies()[name]
    # each pair: start and end one tick (1.5 ms) apart
    assert (t["calls"], t["pending"]) == (3, 0)
    assert t["device_s"] == pytest.approx(3 * 1.5e-3)
    # the pairs go back to the pool and serve the next spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span(name, fake_card):
            pass
    assert _Event.made == 6
    assert tallies()[name]["device_s"] == pytest.approx(4 * 1.5e-3)


def test_a_span_with_no_device_records_no_event(fake_card):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("ops_hook.head_mac"):
            pass
        with span("nonuniform.process", torch.device("cpu")):
            pass
    assert _Event.made == 0 and not profiling._PENDING
    t = tallies()
    assert t["ops_hook.head_mac"]["calls"] == t["nonuniform.process"][
        "calls"] == 1


def test_reset_drops_the_pending_extents(fake_card):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("nonuniform.tail_step", fake_card):
            pass
    assert tallies()["nonuniform.tail_step"]["pending"] == 1
    ops_hook.reset_counts()
    _Event.passed = True
    t = tallies()["nonuniform.tail_step"]
    assert t == {"calls": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                 "pending": 0}
    assert len(profiling._POOL[0]) == 2


def test_a_long_profile_resolves_the_pairs_the_card_has_passed(
        fake_card, monkeypatch):
    monkeypatch.setattr(profiling, "DRAIN_AT", 4)

    def step():
        with span("nonuniform.tail_step", fake_card):
            pass

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            step()
        assert len(profiling._PENDING) == 3
        _Event.upto = _Event.clock            # the card passes those three
        step()                                # the fourth reaches DRAIN_AT
        assert len(profiling._PENDING) == 1
        assert len(profiling._POOL[0]) == 6
        for _ in range(10):                   # the card passes none of these
            step()
        assert len(profiling._PENDING) == 11
        _Event.passed = True
        step()
        # nothing pending, and every event made is back in the pool
        assert not profiling._PENDING
        assert len(profiling._POOL[0]) == _Event.made
    t = profiling._TALLIES["nonuniform.tail_step"]
    assert (t["calls"], t["pending"]) == (15, 0)
    assert t["device_s"] == pytest.approx(15 * 1.5e-3)
