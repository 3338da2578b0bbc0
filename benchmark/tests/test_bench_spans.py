"""The per-layer metrics read from the program's spans
(``benchmark/spans.py`` and the readers whose source is
``program_span``), on the CPU."""

import sys

import pytest

from benchmark import spec
from benchmark.run import run_cell
from benchmark.tests import tiny
from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.tracing import Call

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPANS = {m["name"]: m for m in BENCH["per_layer"]
         if m["source"] == "program_span"}


class Traced:
    """A run with a trace (the readers look only at its presence)."""
    trace, records, units, work = object(), [], 0, {}


def _call(name, children):
    """A recorded call holding ``children``, ``(name, device_ms)`` each."""
    kids = [Call(n, ms, ms, {}, []) for n, ms in children]
    return Call(name, 0.0, sum(ms for _, ms in children) + 0.5, {}, kids)


def test_each_span_metric_is_declared_as_the_contract_asks():
    """Whatever ``program_span`` metrics the benchmark holds: milliseconds,
    lower is better, and a reader that names a unit span and at least one
    span inside it, for cells the benchmark has."""
    for name, m in SPANS.items():
        assert (m["unit"], m["better"]) == ("ms", "lower"), name
        stages = spec.metric(name).STAGES
        assert stages and all(stages.values()), name
        assert set(m.get("workloads", CELLS)) <= set(CELLS), name


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_gives_the_least_call_of_its_named_spans(name, monkeypatch):
    """Three fabricated calls of each unit span: the reader sums the named
    spans inside each call (every instance, at any depth) and takes the
    least; other spans and other units do not count."""
    mod = spec.metric(name)
    unit, names = next(iter(mod.STAGES.items()))
    calls = []
    for base in (5.0, 2.0, 3.0):
        kids = [(n, base + i) for i, n in enumerate(names)]
        kids += [(names[0], 1.0), ("other.stage", 100.0)]
        calls.append(_call(unit, kids))
    calls.append(_call(unit, [("other.stage", 0.1)]))  # no named span
    calls.append(_call("another.unit", [(names[0], 0.01)]))
    want = min(sum(c.below[n].device_ms for n in names) for c in calls[:3])
    assert want == 2.0 * len(names) + sum(range(len(names))) + 1.0
    monkeypatch.setattr(tracing, "calls", lambda unit=None: [
        c for t in calls for c in t.walk() if c.name == unit])
    assert mod.read(Traced()) == pytest.approx(want)
    empty = type("Run", (), {"trace": None})()
    assert mod.read(empty) is None


def test_kernel_stage_reads_kpcn_where_sbmc_recorded_nothing(monkeypatch):
    mod = spec.metric("kernel_stage_ms.denoise")
    calls = [_call("kpcn.forward", [("kpcn.diffuse", 9.0),
                                    ("kpcn.apply", ms)]) for ms in (4, 3)]
    monkeypatch.setattr(tracing, "calls", lambda unit=None: [
        c for c in calls if c.name == unit])
    assert mod.read(Traced()) == 3.0


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_reads_nothing_without_the_program_s_spans(name,
                                                          monkeypatch):
    """A program without ``sbmc_tpu_torch.tracing`` (the parent of the
    change that added it) or a store with no such call: None."""
    tracing.reset()
    mod = spec.metric(name)
    assert mod.read(Traced()) is None
    monkeypatch.setitem(sys.modules, "sbmc_tpu_torch.tracing", None)
    assert mod.read(Traced()) is None


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_runs_report_the_span_metrics_only_when_traced(cell):
    """A small traced run of each cell reports exactly the span metrics
    that list it (none, for a cell no such metric lists); an untraced one
    reports none."""
    cfg, t = tiny.cell(cell, BENCH)
    mine = {m["name"] for m in spec.layer_metrics(BENCH, cell)} & set(SPANS)
    for traced in (True, False):
        tracing.reset()
        r = run_cell(BENCH, cell, 2 ** 33 + 7, 0.3, traced, device="cpu",
                     config=cfg, traffic=t)
        assert r["correct"] is True
        got = set(r["metrics"]) & set(SPANS)
        assert got == (mine if traced else set()), (traced, got)
        for n in got:
            assert r["metrics"][n]["value"] > 0
    tracing.reset()
