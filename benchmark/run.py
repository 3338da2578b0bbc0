"""One run of one cell of the benchmark of ``sbmc_tpu_torch``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Resolves the cell in ``BENCHMARK.json`` to its configuration, traffic and
limits, makes its weights and inputs from ``--seed`` on the card, warms
up, then, with ``--trace 0``, drives the program for ``--seconds`` and
reports the cell's end-to-end metrics; with ``--trace 1`` it drives a fixed
stretch (the traffic's ``traced`` units) under ``torch.profiler`` and
reports the per-layer metrics, ``busy_s``, ``window_s`` and the breakdown.
Either way it then frees the program and compares what the window produced
with the float32 reference (:mod:`benchmark.compare`), prints each compared
number beside its limit as the last lines of standard error, and prints one
JSON object as the last line of standard output.

Exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for; exits 3 if ``jax``, ``jaxlib``, ``flax`` or ``sbmc_tpu``
(whole top-level names) were imported by the time the window closed.
"""

import time

T0 = time.perf_counter()  # set-up is counted from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import compare, spec  # noqa: E402
from benchmark.cell import Cell, sync  # noqa: E402
from benchmark.trace import traced  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sbmc_tpu")


def forbidden_modules(modules=None):
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    forbidden, compared whole: ``sbmc_tpu_torch`` is not ``sbmc_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Run:
    """What the per-layer readers read."""

    def __init__(self, records, trace, work):
        self.records, self.trace, self.work = records, trace, work
        self.units = len(records)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(bench, name, seed, seconds, trace, device="cuda", t0=None,
             config=None, traffic=None):
    """Run cell ``name`` once; returns the result dict. ``config`` and
    ``traffic`` replace the cell's files (tests run cells at small sizes
    on the CPU)."""
    wl = spec.workload(bench, name)
    cfg = config or spec.config(bench, wl["config"])
    tr = traffic or spec.traffic(wl["traffic"])
    lim = compare.load_limits(name)
    cell = Cell(name, cfg, tr, seed, device)
    dev = cell.device
    # The entry points' setting: float32 stays float32, and the reference
    # (float32) runs without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = spec.driver(tr["kind"])
    state = driver.setup(cell)
    setup_s = time.perf_counter() - (T0 if t0 is None else t0)

    summary = None
    if trace:
        records, summary = traced(lambda i: driver.unit(state, i),
                                  tr["traced"], dev)
    else:
        records, start = [], time.perf_counter()
        while time.perf_counter() - start < seconds:
            records.append(driver.unit(state, len(records)))
        sync(dev)
        window_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    work = driver.work(state)
    correct, check = compare.judge(driver.check(state)["program"], lim)

    metrics = {}
    if trace:
        run = Run(records, summary, work)
        for m in spec.layer_metrics(bench, name):
            value = spec.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.e2e(state, records, window_s), setup_s=setup_s)
        for m in spec.e2e_metrics(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    cuda = dev.type == "cuda"
    result = {"correct": correct, "attempted": len(records), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else dev.type),
                         "count": wl["chips"],
                         "memory_peak_bytes": peak,
                         "power_limit_w": _power_limit() if cuda else None}}
    if trace:
        result["device"]["busy_s"] = summary.busy_s if summary else 0.0
        result["device"]["window_s"] = summary.window_s if summary else 0.0
        if summary:
            result["breakdown"] = summary.breakdown()
    result["check"] = check
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("benchmark: cell %s needs %d CUDA device(s); found %d"
              % (args.workload, chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print("benchmark: the run imported %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print("check %s %r limit %r" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
