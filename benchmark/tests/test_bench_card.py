"""On the card: each cell, run as the benchmark's command runs it, is
correct, and its controls are not.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark.lib import cells

from .helpers import CELLS


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 41),
                          "--seconds", "1", "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", name, "--seeds", "5,6,7",
                          "--seconds", "0.5"], cwd=cells.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
