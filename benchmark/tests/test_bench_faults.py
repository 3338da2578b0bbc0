"""A whole run of each cell at a small size on the CPU (past the look for
a card), sound and with the timed path broken underneath: each fault the
cell can have (``faults/<arch>.<kind>.py``) turns ``correct`` false under
the cell's own limits."""

import pytest

from benchmark import spec
from benchmark.run import run_cell
from benchmark.tests import faults, tiny

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 33 + 5


def _faults(cell):
    return faults.load(tiny.arch(cell, BENCH), tiny.kind(cell, BENCH))


CASES = [(c, None) for c in CELLS] + [(c, f) for c in CELLS
                                      for f in _faults(c)]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_faults(cell):
    assert _faults(cell)


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    cfg, traffic = tiny.cell(cell, BENCH)
    if fault:
        _faults(cell)[fault](monkeypatch)
    r = run_cell(BENCH, cell, SEED, 0.2, False, device="cpu", config=cfg,
                 traffic=traffic)
    assert r["correct"] is (fault is None), r["check"]
