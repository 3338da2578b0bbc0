"""The readings that a cell's comparison limits are set from, at the
cell's own size, several seeds in one process.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3 \\
        [--variants control half_batch]

For each seed: the cell's set-up, one unit through the timed path (a frame,
or for a training cell the set-up's checked steps), then the comparison
with the float32 reference (``program``: the lower readings) and, for each
variant, the same numbers of a stand-in for the program against the
reference: ``control``, the reference computed in float8 (a precision
below the configuration's bfloat16); ``half_batch`` (training), the
reference on the first half of each batch. One JSON line a seed. The
benchmark's own runs do not run these variants.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.cell import Cell  # noqa: E402


def readings(bench, name, seed, variants, device="cuda", config=None,
             traffic=None):
    """``{"program": numbers, <variant>: numbers ...}`` of one seed."""
    wl = spec.workload(bench, name)
    cfg = config or spec.config(bench, wl["config"])
    tr = traffic or spec.traffic(wl["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = spec.driver(tr["kind"])
    state = driver.setup(Cell(name, cfg, tr, seed, device))
    if tr["kind"] != "train":
        for i in range(tr["frames"]):
            driver.unit(state, i)
    out = driver.check(state, variants)
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="*", default=["control"])
    args = p.parse_args(argv)
    bench = spec.load()
    for seed in args.seeds:
        out = readings(bench, args.workload, seed, args.variants)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
