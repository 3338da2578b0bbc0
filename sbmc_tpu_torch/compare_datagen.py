"""The datagen CLI in two checkouts of the repo, in turns.

    python -m sbmc_tpu_torch.compare_datagen PARENT [--rounds 2]
        [--device cuda] [-- CLI arguments]

Runs ``python -m sbmc_tpu_torch.generate_training_data`` with the same
arguments in PARENT (another checkout, e.g. ``git archive`` of the parent
commit unpacked) and in this checkout, each run a fresh process writing to
a fresh folder, in turns: parent, change, change, parent per round, so that
a drift of the machine weighs on both alike. The first run of each checkout
builds its kernels: its line is printed and left out of the medians. By
default the arguments are the corpus configuration of ``chip_smoke.py``
(2 scenes of 256x256, tiles of 128, 8 spp, gt 512, the repo's assets).
Prints each run's summary line, then one JSON line with each side's s/scene
and its median.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["--renderer", "wavefront", "--count", "2", "--width", "256",
          "--height", "256", "--tile_size", "128", "--spp", "8",
          "--gt_spp", "512"]
_LINE = re.compile(r"wavefront datagen: \d+ scenes in [\d.]+ s "
                   r"\(([\d.]+) s/scene\)")


def run(tree, cli_args, device):
    """One CLI run in checkout ``tree``: (s/scene, summary line)."""
    assets = os.path.join(tree, "assets")
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "sbmc_tpu_torch.generate_training_data",
             "-", "-", assets, out] + cli_args + [
                "--obj_dir", os.path.join(assets, "objs"), "--tex_dir",
                os.path.join(assets, "textures"), "--env_dir",
                os.path.join(assets, "envmaps"), "--device", device],
            cwd=tree, capture_output=True, text=True)
    found = [m for m in map(_LINE.search, proc.stdout.splitlines()) if m]
    if proc.returncode or not found:
        raise RuntimeError("the CLI failed in %s:\n%s" % (
            tree, proc.stderr[-3000:]))
    return float(found[-1].group(1)), found[-1].group(0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent", help="the other checkout")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("cli_args", nargs="*", default=CORPUS,
                        help="the CLI's arguments (after --)")
    args = parser.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    times = {"parent": [], "change": []}
    for tag in ("parent", "change"):
        print("%s (builds its kernels): %s" % (tag, run(
            trees[tag], args.cli_args, args.device)[1]), flush=True)
    for _ in range(args.rounds):
        for tag in ("parent", "change", "change", "parent"):
            s, line = run(trees[tag], args.cli_args, args.device)
            times[tag].append(s)
            print("%s: %s" % (tag, line), flush=True)
    print(json.dumps({tag: {"s_per_scene": t, "median": statistics.median(t)}
                      for tag, t in times.items()}))
    return times


if __name__ == "__main__":
    main()
