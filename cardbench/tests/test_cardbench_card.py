"""On the card: the control, at a cell's own size, comes out not correct
on three seeds while the program comes out correct, below the limit.  Skips without a card; run
on the chip with ``python3 -m pytest cardbench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["pod1024_render", "pod1024_live"])
def test_the_control_fails_and_the_program_holds_at_full_size(card, cell):
    p = subprocess.run(
        [sys.executable, "cardbench/control.py", "--workload", cell,
         "--seeds", "101", "202", "303", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["lower"] < summary["limit"] < summary["upper"]
    assert summary["program_correct_control_not"]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()[:-1]]
    assert [x["control_correct"] for x in lines] == [False] * 3
