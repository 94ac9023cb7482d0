"""Fixtures of the benchmark's own tests: a copy of the benchmark with a
tiny configuration added, and the look for a card (made in a fixture,
never while a module is imported)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda:0")


def copy_bench(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``cardbench/`` copied under ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", dest / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


def add_tiny(dest: Path) -> dict:
    """Add the tiny configuration, two tiny mixes, their cells
    (``tiny_render``, ``tiny_live``) and metrics to the copy at ``dest``,
    as a later change would: new files and new entries, no file edited;
    the metrics' readers are those already there (``rtf.tiny`` is read by
    ``metrics/rtf.py``)."""
    bench = dest / "cardbench"
    shutil.copy(DATA / "tiny.json", bench / "configs" / "tiny.json")
    for t in ("render_tiny", "live_tiny"):
        shutil.copy(DATA / f"{t}.json", bench / "traffic" / f"{t}.json")
    raw = json.loads((dest / "BENCHMARK.json").read_text())
    raw["configs"].append({"name": "tiny", "source": "tests",
                           "file": "cardbench/configs/tiny.json",
                           "reduced": [], "why": "tests"})
    for traffic, cell in (("render_tiny", "tiny_render"),
                          ("live_tiny", "tiny_live")):
        raw["workloads"].append({"name": cell, "config": "tiny",
                                 "traffic": traffic, "chips": 1,
                                 "why": "tests"})
    raw["end_to_end"] += [
        {"name": "rtf.tiny", "unit": "x", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny_render"]},
        {"name": "block_ms_p99.tiny", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": ["tiny_live"]}]
    raw["per_layer"] += [
        {"name": "device.idle_pct.render.tiny", "unit": "%",
         "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "rtf.tiny", "workloads": ["tiny_render"]},
        {"name": "device.busy_ms_per_block.live.tiny", "unit": "ms",
         "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "block_ms_p99.tiny", "workloads": ["tiny_live"]}]
    (dest / "BENCHMARK.json").write_text(json.dumps(raw, indent=1))
    return raw


def add_matrix_tiny(dest: Path) -> dict:
    """Add a tiny matrix configuration (4 inputs mixed to 2 outputs, 4
    partitions), a live mix that exchanges its filters every 8 blocks, the
    cell ``mtiny_live`` and its metrics to the copy at ``dest``: new files
    only, the engine adapter and the plain reference among them."""
    bench = dest / "cardbench"
    shutil.copy(DATA / "mtiny.json", bench / "configs" / "mtiny.json")
    shutil.copy(DATA / "live_exchange_tiny.json",
                bench / "traffic" / "live_exchange_tiny.json")
    shutil.copy(DATA / "engine_matrix.py", bench / "engines" / "matrix.py")
    shutil.copy(DATA / "reference_matrix.py",
                bench / "reference" / "matrix.py")
    raw = json.loads((dest / "BENCHMARK.json").read_text())
    raw["configs"].append({"name": "mtiny", "source": "tests",
                           "file": "cardbench/configs/mtiny.json",
                           "reduced": [], "why": "tests"})
    raw["workloads"].append({"name": "mtiny_live", "config": "mtiny",
                             "traffic": "live_exchange_tiny", "chips": 1,
                             "why": "tests"})
    raw["end_to_end"].append(
        {"name": "block_ms_p99.mtiny", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": ["mtiny_live"]})
    raw["per_layer"].append(
        {"name": "device.busy_ms_per_block.live.mtiny", "unit": "ms",
         "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "block_ms_p99.mtiny", "workloads": ["mtiny_live"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(raw, indent=1))
    return raw


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    from cardbench.core import manifest

    dest = copy_bench(tmp_path_factory.mktemp("bench"))
    add_tiny(dest)
    return manifest.load(dest, dest / "cardbench")


@pytest.fixture(scope="module")
def matrix_bench(tmp_path_factory):
    from cardbench.core import manifest

    dest = copy_bench(tmp_path_factory.mktemp("bench"))
    add_matrix_tiny(dest)
    return manifest.load(dest, dest / "cardbench")
