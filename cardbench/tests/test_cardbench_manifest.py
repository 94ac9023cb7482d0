"""The manifest keeps to its contract, and every cell's files are found
by name; a configuration added as files and entries is picked up with no
file of the harness edited."""

import hashlib
import json
import re

import pytest

from cardbench.core import manifest

from conftest import ROOT, add_tiny, copy_bench

RAW = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_the_manifest_has_exactly_the_contracts_keys():
    assert set(RAW) == TOP
    assert RAW["command"] == ["python3", "cardbench/run.py"]
    assert RAW["paths"] == ["cardbench"]
    assert isinstance(RAW["run_seconds"], int) and 1 <= RAW["run_seconds"] <= 51
    for c in RAW["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in RAW["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in RAW["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in RAW["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_every_name_and_unit_uses_only_the_allowed_characters(section):
    names = [e["name"] for e in RAW[section]]
    assert len(set(names)) == len(names)
    for e in RAW[section]:
        assert manifest.NAME.fullmatch(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert manifest.NAME.fullmatch(e[key])
        for key in e.get("reduced", []):
            assert manifest.NAME.fullmatch(key)
        if "unit" in e:
            assert manifest.UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and not isinstance(e[key], (int, float)):
                assert LINE.fullmatch(e[key]), (key, e[key])


def test_the_metrics_each_cell_reports_keep_the_contract():
    bench = manifest.load()
    e2e = {m["name"] for m in RAW["end_to_end"]}
    for m in RAW["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in bench.end_to_end_for(cell)}
    for cell in bench.cells:
        names = {m["name"] for m in bench.end_to_end_for(cell)}
        assert "setup_s" in names and len(names) >= 2
        assert bench.per_layer_for(cell)
    layers = {m["layer"] for m in RAW["per_layer"]}
    assert layers == {"engine and dispatch", "device", "kernels"}


@pytest.mark.parametrize("cell", [w["name"] for w in RAW["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench = manifest.load()
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    tr = bench.traffic(w["traffic"])
    assert hasattr(bench.driver(tr["driver"]), "Driver")
    assert hasattr(bench.engine(cfg["engine"]), "Engine")
    reference = bench.reference(cfg["engine"])
    for fn in ("filters", "memory", "outputs"):
        assert callable(getattr(reference, fn))
    for m in bench.end_to_end_for(cell) + bench.per_layer_for(cell):
        assert callable(bench.reader(m["name"]).read)
    entry = bench.configs[w["config"]]
    assert entry["file"].startswith("cardbench/configs/")
    assert set(cfg["reduced"]) == set(entry["reduced"])


def test_each_kernel_mapping_names_a_function_and_the_rooflines_load():
    bench = manifest.load()
    fn = bench.kernel_functions()
    assert fn["resident_kernel"] == fn["windows_kernel"] == "k1_fused_head"
    assert fn["xt_mac_general_kernel"] == "k2_xt_grouped_mac"
    for f in set(fn.values()):
        roof = bench.roofline(f)
        assert roof is None or (callable(roof.cost) and roof.COUNTER)
    assert bench.roofline("k1_fused_head").COUNTER == "fused_head"


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_throwaway_configuration_is_picked_up_with_no_file_edited(tmp_path):
    dest = copy_bench(tmp_path)
    before = _digests(dest / "cardbench")
    add_tiny(dest)
    after = _digests(dest / "cardbench")
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == set()
    added = set(after) - set(before)
    assert added == {"configs/tiny.json", "traffic/render_tiny.json",
                     "traffic/live_tiny.json"}
    bench = manifest.load(dest, dest / "cardbench")
    assert bench.config("tiny")["channels"] == 3
    assert bench.traffic(bench.cell("tiny_live")["traffic"])["driver"] == \
        "paced_blocks"
    assert [m["name"] for m in bench.end_to_end_for("tiny_render")] == \
        ["setup_s", "rtf.tiny"]
    assert [m["name"] for m in bench.per_layer_for("tiny_live")] == [
        "device.busy_ms_per_block.live.tiny"]
    assert bench.reader("rtf.tiny") is bench.reader("rtf")


def test_a_metric_is_read_by_its_own_file_else_its_longest_prefix(tmp_path):
    dest = copy_bench(tmp_path)
    bench = manifest.load(dest, dest / "cardbench")
    assert bench.reader("device.idle_pct.render.pod1024") is \
        bench.reader("device.idle_pct.render")
    assert bench.reader("setup_s").__name__.endswith("setup_s")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such.metric")
    own = dest / "cardbench" / "metrics" / "rtf.other.py"
    own.write_text("def read(ctx):\n    return 7.0\n")
    bench = manifest.load(dest, dest / "cardbench")
    assert bench.reader("rtf.other").read(None) == 7.0
    assert bench.reader("rtf.other.x").read(None) == 7.0
    assert bench.reader("rtf.hoa64") is not bench.reader("rtf.other")


def test_a_per_layer_metric_that_lists_no_cells_goes_with_what_it_moves():
    raw = json.loads(json.dumps(RAW))
    raw["per_layer"].append(
        {"name": "x.everywhere", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "setup_s"})
    bench = manifest.Bench(raw)
    for cell in bench.cells:
        assert "x.everywhere" in {m["name"] for m in bench.per_layer_for(cell)}


def test_an_unknown_cell_or_a_bad_name_is_refused():
    bench = manifest.load()
    with pytest.raises(KeyError):
        bench.cell("no_such_cell")
    with pytest.raises(ValueError):
        bench.traffic("../etc")
