"""Each cell of ``BENCHMARK.json`` at a size the CPU runs in seconds: its
configuration with the model sizes under the file's ``tiny`` key, its
traffic with the frame or tile under the traffic file's ``tiny`` key.
Tests run the cells' own drivers, comparison and limits on these."""

import copy

from benchmark import spec

__all__ = ["cell", "kind", "arch"]


def cell(name, bench=None):
    """``(config, traffic)`` of cell ``name`` at its small size."""
    bench = bench or spec.load()
    wl = spec.workload(bench, name)
    cfg = copy.deepcopy(spec.config(bench, wl["config"]))
    cfg["model"].update(cfg["tiny"])
    traffic = spec.traffic(wl["traffic"])
    traffic.update(traffic["tiny"])
    return cfg, traffic


def kind(name, bench=None):
    """The traffic kind of cell ``name``."""
    bench = bench or spec.load()
    return spec.traffic(spec.workload(bench, name)["traffic"])["kind"]


def arch(name, bench=None):
    """The architecture of cell ``name``."""
    bench = bench or spec.load()
    return spec.config(bench, spec.workload(bench, name)["config"])["arch"]
