"""Compute image-quality metrics over ``.exr`` outputs (counterpart of
``scripts/compute_metrics.py``).

    python -m sbmc_tpu_torch.compute_metrics REF_DIR out.csv \\
        --methods OUT/4spp_ours OUT/4spp_nfor --scenes scene.exr \\
        [--pad 21] [--stats stats.csv] [--latex table.tex]

Everything runs in numpy on the host; no device is used.
"""

import argparse

from sbmc_tpu_torch import evaluation
from sbmc_tpu_torch.utils.logging import set_logger

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("ref", help="folder with reference .exr images")
    parser.add_argument("output", help="output .csv path")
    parser.add_argument("--methods", nargs="+", required=True,
                        help="folders with method outputs (or a .txt list)")
    parser.add_argument("--scenes", nargs="+", required=True,
                        help=".exr scene filenames (or a .txt list)")
    parser.add_argument("--pad", type=int, default=21,
                        help="border pixels to exclude")
    parser.add_argument("--stats", help="optional aggregated stats .csv")
    parser.add_argument("--latex", help="optional LaTeX table output path")
    return parser.parse_args(argv)


def main(args):
    """Writes the per-scene CSV (and the stats and LaTeX files when asked);
    returns the per-scene rows."""
    rows = evaluation.compute(args.ref, args.output, args.methods,
                              args.scenes, pad=args.pad)
    if args.stats or args.latex:
        mean_rows, _ = evaluation.stats(
            [args.output], args.stats or args.output + ".stats.csv")
        if args.latex:
            evaluation.to_latex(mean_rows, args.latex)
    return rows


if __name__ == "__main__":
    set_logger()
    main(parse_args())
