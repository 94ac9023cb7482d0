"""Without a card ``run.py`` exits nonzero and prints no result; with a
forbidden package loaded it would refuse too (whole top-level names)."""

import subprocess
import sys

import pytest

from conftest import ROOT, copy_bench


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "cardbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


@pytest.mark.parametrize("trace", ["0", "1"])
def test_without_a_card_run_exits_nonzero_and_prints_nothing(trace):
    _no_card()
    p = _run(ROOT, "--workload", "pod1024_render", "--seed", str(2 ** 33 + 1),
             "--seconds", "1", "--trace", trace)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA card" in p.stderr
    assert "memory_peak_bytes" not in p.stderr


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    _no_card()
    copy_bench(tmp_path)
    p = _run(tmp_path, "--workload", "pod1024_live", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_packages_are_found_by_whole_top_level_name(monkeypatch):
    sys.path.insert(0, str(ROOT / "cardbench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "cardbench"))
    assert run.forbidden_loaded() == []
    for name in ("jaxtyping", "jax_fake_helper", "flaxen", "bbcat_dsp_torch"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "bbcat_dsp_tpu", object())
    assert run.forbidden_loaded() == ["bbcat_dsp_tpu", "jaxlib"]
