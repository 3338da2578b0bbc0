"""One short run of each cell on the card (``-m cuda``): it builds, runs
and comes out correct. Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "12345678901", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().split("\n")[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
