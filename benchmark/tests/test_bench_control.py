"""The control at a small size on the CPU: the reference computed in
float8 in the program's place, and each other stand-in its driver reads
(``VARIANTS``), comes out not correct under each cell's limits, where the
program comes out correct. The readings at the cells' own sizes come from
``benchmark/control.py`` on the card (PERF.md)."""

import pytest

from benchmark import compare, control, spec
from benchmark.tests import tiny

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    cfg, traffic = tiny.cell(cell, BENCH)
    variants = list(spec.driver(traffic["kind"]).VARIANTS)
    limits = compare.load_limits(cell)
    out = control.readings(BENCH, cell, 2 ** 32 + 3, variants, "cpu", cfg,
                           traffic)
    assert compare.judge(out["program"], limits)[0], out["program"]
    for v in variants:
        assert not compare.judge(out[v], limits)[0], (v, out[v])
