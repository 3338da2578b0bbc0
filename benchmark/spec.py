"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``benchmark/configs/<name>.json`` (its ``file``);
- a traffic mix: ``benchmark/traffic/<name>.json``, whose ``kind`` names
  the driver ``benchmark/drivers/<kind>.py`` that generates it;
- a cell's comparison limits: ``benchmark/limits/<workload>.json``;
- a per-layer metric: ``benchmark/metrics/<name>.py``, which holds
  ``UNIT``, ``LAYER``, ``MOVES`` and ``read(run)``.
"""

import importlib
import importlib.util
import json
import os
import re

__all__ = ["ROOT", "HERE", "NAME", "UNIT", "load", "workload", "config",
           "traffic", "driver", "metric", "e2e_metrics", "layer_metrics"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path):
    with open(path) as f:
        return json.load(f)


def load(path=None):
    return _json(path or os.path.join(ROOT, "BENCHMARK.json"))


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("no %s named %r in BENCHMARK.json" % (what, name))


def workload(spec, name):
    return _named(spec["workloads"], name, "workload")


def config(spec, name):
    """The configuration file of configuration ``name``."""
    return _json(os.path.join(ROOT, _named(spec["configs"], name,
                                           "configuration")["file"]))


def traffic(name):
    return _json(os.path.join(HERE, "traffic", name + ".json"))


def driver(kind):
    return importlib.import_module("benchmark.drivers." + kind)


def metric(name):
    """The reader module of per-layer metric ``name`` (a file name may
    hold dots, so it is loaded from its path)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _applies(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def e2e_metrics(spec, cell):
    """The end-to-end metrics a cell reports."""
    return [m for m in spec["end_to_end"] if _applies(m, cell)]


def layer_metrics(spec, cell):
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in e2e_metrics(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]
