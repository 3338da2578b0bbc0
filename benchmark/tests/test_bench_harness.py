"""The benchmark's files, contract and result line, on the CPU."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import arch as arches
from benchmark import compare, spec, trace
from benchmark.arch import kpcn, sbmc
from benchmark.reference import models
from benchmark.reference.models import leaves
from benchmark.reference.names import program_name
from benchmark.run import forbidden_modules, run_cell
from benchmark.tests import tiny

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYERS = [m["name"] for m in BENCH["per_layer"]]
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section, keys, extra", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"},
     {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"},
     {"workloads"}),
])
def test_entries_have_the_contract_keys(section, keys, extra):
    for e in BENCH[section]:
        assert keys <= set(e) <= keys | extra, e["name"]


def test_names_and_units_use_allowed_characters():
    names = [e["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[s]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                         "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), names
    assert len(set(names[:len(names) - 2 * len(CELLS)])) == len(
        names[:len(names) - 2 * len(CELLS)])
    units = [m["unit"] for s in ("end_to_end", "per_layer")
             for m in BENCH[s]]
    assert all(spec.UNIT.match(u) for u in units), units
    lines = [e[k] for s in ("configs", "workloads") for e in BENCH[s]
             for k in ("why", "source") if k in e]
    lines += [m["layer"] for m in BENCH["per_layer"]]
    assert all(LINE.match(x) for x in lines)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for c in m["workloads"]:
            assert c in CELLS
            assert e2e[m["moves"]].get("workloads", CELLS).count(c) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    wl = spec.workload(BENCH, cell)
    assert wl["chips"] in (1, 4)
    cfg = spec.config(BENCH, wl["config"])
    traffic = spec.traffic(wl["traffic"])
    assert spec.driver(traffic["kind"])
    assert arches.load(cfg["arch"]).program
    assert models.leaves(cfg)
    assert compare.load_limits(cell)
    e2e = [m["name"] for m in spec.e2e_metrics(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.layer_metrics(BENCH, cell)


READERS = sorted(f[:-3] for f in os.listdir(os.path.join(spec.HERE,
                                                          "metrics"))
                 if f.endswith(".py"))


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_from_nothing(name):
    mod = spec.metric(name)
    assert spec.UNIT.match(mod.UNIT) and mod.LAYER and mod.MOVES
    empty = type("Run", (), {"trace": None, "records": [], "units": 0,
                             "work": {}})()
    assert mod.read(empty) is None


@pytest.mark.parametrize("name", LAYERS)
def test_each_layer_metric_has_its_reader(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = spec.metric(name)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])


def test_configurations_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = spec.config(BENCH, c["name"])
        assert set(c["reduced"]) <= set(cfg["model"]) | set(cfg)
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))


def _hand_sbmc(h, w, spp):
    # Embeddings: 96 -> 128 -> 128 -> 128, then (128 + 128) -> 128 x 2.
    emb = (96 * 128 + 2 * 128 * 128) + 2 * (256 * 128 + 2 * 128 * 128)
    reg = 256 * 128 + 128 * 128 + 128 * 441
    lvl0 = 3 * 128 * 128 * 9 + (384 * 128 + 2 * 128 * 128) * 9
    lvl1 = (128 * 256 + 2 * 256 * 256) * 9 + (768 * 256 + 2 * 256 * 256) * 9
    lvl2 = (256 * 512 + 2 * 512 * 512) * 9
    unet = lvl0 * h * w + lvl1 * (h // 2) * (w // 2) \
        + lvl2 * (h // 4) * (w // 4)
    return 2 * ((emb + reg) * h * w * spp + 3 * unet) \
        + 2 * 441 * 4 * h * w * spp


def test_flop_counters_match_hand_counts():
    s = spec.config(BENCH, "sbmc_flagship")
    k = spec.config(BENCH, "kpcn")
    assert sbmc.flops(s, 1080, 1920, 4) == _hand_sbmc(1080, 1920, 4)
    chain = 27 * 100 * 25 + 7 * 100 * 100 * 25 + 100 * 441 * 25
    assert kpcn.flops(k, 1080, 1920) == (2 * 2 * chain + 4 * 441 * 4) \
        * 1080 * 1920
    fwd = _hand_sbmc(128, 128, 8) - 2 * 441 * 4 * 128 * 128 * 8
    first = 2 * 96 * 128 * 128 * 128 * 8
    assert sbmc.train_flops(s, 4, 128, 128, 8) == 4 * (
        3 * fwd - first + 2 * 2 * 441 * 4 * 128 * 128 * 8)


def test_byte_counters_match_hand_counts():
    s = spec.config(BENCH, "sbmc_flagship")
    k = spec.config(BENCH, "kpcn")
    # B1 at (1, 3, 1080, 2048) bf16: 441 bf16 logits, 3 data planes, the
    # state (3 + 2 planes) read and written, all float32: 0.6167 ms.
    b1 = 1080 * 2048 * (441 * 2 + 3 * 4 + 2 * 5 * 4)
    assert sbmc.kernel_bytes(s, [(1080, 2048)], 4) == {"splat_bytes":
                                                       4 * b1}
    assert abs(b1 / 3.35e12 * 1e3 - 0.6167) < 1e-4
    b4 = 1124 * 1964 * (441 * 2 + 3 * 4 + 3 * 4 + 4)
    assert kpcn.kernel_bytes(k, [(1160, 2000)]) == {"kw_bytes": 2 * b4}
    # B4 at (4, 3, 92, 92) float32 is PERF.md's 0.0181 ms.
    f32 = 4 * 92 * 92 * (441 * 4 + 3 * 4 + 3 * 4 + 4)
    assert abs(f32 / 3.35e12 * 1e3 - 0.0181) < 1e-4


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_reference_names_map_onto_the_program(name):
    cfg = spec.config(BENCH, name)
    with torch.device("meta"):
        params = {n: torch.empty(shape) for n, shape, _, _ in leaves(cfg)}
        net = arches.load(cfg["arch"]).program(cfg, params, "meta")
    mine = {program_name(n): tuple(v.shape) for n, v in params.items()}
    assert mine == {k: tuple(v.shape) for k, v in net.state_dict().items()}


def test_forbidden_modules_compare_whole_names():
    assert forbidden_modules(["sbmc_tpu_torch", "sbmc_tpu_torch.ops",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["sbmc_tpu.ops", "jax", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                 "sbmc_tpu"]


def test_a_run_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import spec, run\n"
            "from benchmark.tests import tiny\n"
            "cfg, t = tiny.cell(%r)\n"
            "r = run.run_cell(spec.load(), %r, 5, 0.2, False, device='cpu',"
            " config=cfg, traffic=t)\n"
            "print(r['correct'], run.forbidden_modules())\n"
            % (spec.ROOT, CELLS[0], CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_without_cuda_a_run_exits_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contract_keys(cell, traced):
    cfg, t = tiny.cell(cell, BENCH)
    r = run_cell(BENCH, cell, 2 ** 33 + 1, 0.3, traced, device="cpu",
                 config=cfg, traffic=t)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if traced else []) + ["check"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    assert r["correct"] is True
    want = (spec.layer_metrics if traced else spec.e2e_metrics)(BENCH, cell)
    assert set(r["metrics"]) <= {m["name"] for m in want}
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {m["name"] for m in want}
    json.loads(json.dumps(r))


def test_trace_summary_unions_device_intervals():
    ev = [(trace.WINDOW, False, 0, 1000),
          ("frame", False, 0, 1000), ("wait", False, 450, 700),
          ("k1", True, 100, 300), ("k2", True, 200, 400),
          ("k1", True, 700, 900)]
    s = trace.summarise(ev)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(500e-9)
    assert s.kernel("k1") == (2, pytest.approx(400e-9))
    assert s.gaps == pytest.approx({"frame": 200e-9, "wait": 300e-9})
    assert s.breakdown()["device_ops"][0][0] == "k1"
    assert trace.summarise(ev[1:]) is None
