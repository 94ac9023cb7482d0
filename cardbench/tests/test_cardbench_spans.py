"""The readers of the program's own spans: each on synthetic slice
counters, silent where its span or device extent is absent, and a traced
run of the tiny cells on the CPU, which reads the host metrics and no
device extent."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from cardbench.core import manifest
from cardbench.core.cell import Context, run_cell

from conftest import add_tiny, copy_bench

READERS = {
    "nonuniform.tail_step.device_ms.live": ("pod1024_live",
                                            "block_ms_p99.pod1024"),
    "nonuniform.small_block.host_ms.live": ("pod1024_live",
                                            "block_ms_p99.pod1024"),
    "ops_hook.host_ms.live": ("pod1024_live", "block_ms_p99.pod1024"),
    "nonuniform.process.host_ms.render": ("pod1024_render", "rtf.pod1024"),
}


def _t(calls, host_s, device_s=0.0, pending=0):
    return {"calls": calls, "host_s": host_s, "self_s": host_s / 2,
            "device_s": device_s, "pending": pending}


# a live slice of 16 blocks, two tail firings, and a render slice of 4 calls
SPANS = {
    "nonuniform.small_block": _t(16, 0.0032),
    "nonuniform.input": _t(16, 0.0004),
    "nonuniform.head_step": _t(16, 0.0016),
    "nonuniform.tail_step": _t(2, 0.0010, 0.0086),
    "nonuniform.process": _t(4, 0.0020, 0.0124),
    "ops_hook.rfft_half": _t(18, 0.00036),
    "ops_hook.head_mac": _t(18, 0.00054),
    "ops_hook.irfft_tail": _t(18, 0.00030),
    "ops_hook.rotated_mac": _t(0, 0.0),
}
WANT = {
    "nonuniform.tail_step.device_ms.live": 1e3 * 0.0086 / 2,
    "nonuniform.small_block.host_ms.live": 1e3 * 0.0032 / 16,
    "ops_hook.host_ms.live": 1e3 * (0.00036 + 0.00054 + 0.00030) / 16,
    "nonuniform.process.host_ms.render": 1e3 * 0.0020 / 4,
}
# the span each reader needs, taken out to silence it
NEEDS = {
    "nonuniform.tail_step.device_ms.live": "nonuniform.tail_step",
    "nonuniform.small_block.host_ms.live": "nonuniform.small_block",
    "ops_hook.host_ms.live": "nonuniform.small_block",
    "nonuniform.process.host_ms.render": "nonuniform.process",
}


def _ctx(counters):
    return Context(manifest.load(), 1.0, {},
                   SimpleNamespace(counters=counters))


def _read(name, counters):
    return manifest.load().reader(f"{name}.pod1024").read(_ctx(counters))


def test_the_manifest_lists_each_reader_in_its_cell():
    bench = manifest.load()
    for name, (cell, moves) in READERS.items():
        entry = bench.per_layer[f"{name}.pod1024"]
        assert entry["workloads"] == [cell] and entry["moves"] == moves
        assert entry["layer"] == "engine and dispatch"
        assert entry["source"] == "program_span"
        assert bench.reader(entry["name"]).__file__.endswith(f"{name}.py")


@pytest.mark.parametrize("name", list(READERS))
def test_each_reader_on_synthetic_counters(name):
    assert _read(name, {"launches": {}, "spans": SPANS}) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(READERS))
def test_each_reader_is_silent_where_its_span_is_absent(name):
    assert _read(name, {"launches": {}}) is None      # a program without spans
    spans = dict(SPANS)
    del spans[NEEDS[name]]
    assert _read(name, {"spans": spans}) is None
    spans[NEEDS[name]] = _t(0, 0.0)                   # no call in the slice
    assert _read(name, {"spans": spans}) is None
    ctx = Context(manifest.load(), 1.0, {}, None)     # an untraced run
    assert manifest.load().reader(f"{name}.pod1024").read(ctx) is None


def test_the_device_extent_is_silent_without_one_and_skips_pending_pairs():
    name = "nonuniform.tail_step.device_ms.live"
    spans = dict(SPANS, **{"nonuniform.tail_step": _t(2, 0.001)})
    assert _read(name, {"spans": spans}) is None      # the CPU: no events
    spans["nonuniform.tail_step"] = _t(3, 0.001, 0.0086, pending=1)
    assert _read(name, {"spans": spans}) == pytest.approx(4.3)
    spans["nonuniform.tail_step"] = _t(2, 0.001, 0.0, pending=2)
    assert _read(name, {"spans": spans}) is None


def test_the_ops_hook_reader_sums_only_the_dispatch_spans():
    spans = {k: v for k, v in SPANS.items() if not k.startswith("ops_hook.")}
    assert _read("ops_hook.host_ms.live", {"spans": spans}) is None
    spans["ops_hook.head_mac"] = _t(16, 0.0016)
    assert _read("ops_hook.host_ms.live", {"spans": spans}) == \
        pytest.approx(0.1)


@pytest.fixture(scope="module")
def spans_bench(tmp_path_factory):
    """The tiny cells with the four metrics named for them."""
    dest = copy_bench(tmp_path_factory.mktemp("bench"))
    raw = add_tiny(dest)
    for name, (cell, moves) in READERS.items():
        tiny = cell.replace("pod1024", "tiny")
        raw["per_layer"].append(
            {"name": f"{name}.tiny", "unit": "ms", "better": "lower",
             "source": "program_span", "layer": "engine and dispatch",
             "moves": moves.replace("pod1024", "tiny"), "workloads": [tiny]})
    (dest / "BENCHMARK.json").write_text(json.dumps(raw, indent=1))
    return manifest.load(dest, dest / "cardbench")


@pytest.mark.parametrize("cell, host", [
    ("tiny_live", {"nonuniform.small_block.host_ms.live.tiny",
                   "ops_hook.host_ms.live.tiny"}),
    ("tiny_render", {"nonuniform.process.host_ms.render.tiny"})])
def test_a_traced_cpu_run_reads_the_host_metrics_and_no_device_extent(
        spans_bench, cell, host):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _, _ = run_cell(spans_bench, cell, 2 ** 33 + 18,
                                0.6 if cell == "tiny_live" else 1.0, True,
                                device="cpu", t_process=time.perf_counter(),
                                log=lambda line: None)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"]
    assert {v["unit"] for v in result["metrics"].values()} == {"ms"}
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == host and min(got.values()) > 0
    if cell == "tiny_live":
        # dispatch is a part of the block's host time
        assert got["ops_hook.host_ms.live.tiny"] < \
            got["nonuniform.small_block.host_ms.live.tiny"]
