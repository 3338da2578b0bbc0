"""Plots and LaTeX tables from metric CSVs (counterpart of
``scripts/figures/metrics_report.py``).

    python -m sbmc_tpu_torch.metrics_report OUTPUT --scores A.csv [B.csv] \\
        [--train_logs train_log.csv ...]

Reads the per-scene CSVs of ``python -m sbmc_tpu_torch.compute_metrics``
(either package's) and writes ``error_distributions.png`` (a box plot a
metric of each method's per-scene errors, valid rows only),
``stats.csv`` and ``stats.tex`` (the per-(spp, method) means of
:func:`sbmc_tpu_torch.evaluation.stats`, without pandas) and, for each
``--train_logs`` file, ``<name>_curves.png`` (every column against the
step, log scale). The plots need matplotlib, as the JAX script does; it is
imported when the report starts, and its absence ends the run with a
message. Host-only: nothing here runs on a device.
"""

import argparse
import csv
import os

import numpy as np

from sbmc_tpu_torch import evaluation

__all__ = ["main", "parse_args", "read_columns"]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("metrics_report draws its plots with matplotlib, "
                         "which is not installed (%s); the JAX script "
                         "needs it too" % e) from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _number(v):
    try:
        return float(v)
    except ValueError:
        return float("nan")


def read_columns(path):
    """``{column: float array}`` of a CSV with a header row (empty or
    non-numeric cells read as NaN, as pandas reads them)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = list(rows[0]) if rows else []
    return {c: np.array([_number(r[c]) for r in rows]) for c in cols}


def main(argv=None):
    args = parse_args(argv)
    plt = _pyplot()

    os.makedirs(args.output, exist_ok=True)
    rows = [r for p in args.scores for r in evaluation.read_csv(p)]
    rows = [r for r in rows if r["valid"]]

    metrics = [m for m in evaluation.METRIC_OPS if rows and m in rows[0]]
    methods = sorted({r["method"] for r in rows})

    # Per-metric box plots of the per-scene error distribution by method.
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(3.2 * len(metrics), 3.4))
    if len(metrics) == 1:
        axes = [axes]
    for ax, m in zip(axes, metrics):
        data = [np.array([r[m] for r in rows if r["method"] == meth])
                for meth in methods]
        ax.boxplot(data, tick_labels=methods)
        ax.set_title(evaluation.METRIC_LABELS.get(m, m))
        ax.set_yscale("log")
        ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    dist_path = os.path.join(args.output, "error_distributions.png")
    fig.savefig(dist_path, dpi=150)
    plt.close(fig)
    print("wrote", dist_path)

    # Aggregate table (CSV + LaTeX).
    mean_rows, _ = evaluation.stats(
        args.scores, os.path.join(args.output, "stats.csv"))
    evaluation.to_latex(mean_rows, os.path.join(args.output, "stats.tex"))
    print("wrote", os.path.join(args.output, "stats.csv"), "and .tex")

    # Optional training-curve plot from train_log.csv files.
    for log_csv in args.train_logs or []:
        tl = read_columns(log_csv)
        fig, ax = plt.subplots(figsize=(5, 3.2))
        for col, values in tl.items():
            if col == "step":
                continue
            ax.plot(tl["step"], values, label=col)
        ax.set_xlabel("step")
        ax.set_yscale("log")
        ax.legend()
        fig.tight_layout()
        name = os.path.splitext(os.path.basename(log_csv))[0]
        path = os.path.join(args.output, f"{name}_curves.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        print("wrote", path)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("output", help="output folder for plots/tables")
    parser.add_argument("--scores", nargs="+", required=True,
                        help="per-scene metric CSVs from compute_metrics")
    parser.add_argument("--train_logs", nargs="*",
                        help="optional train_log.csv files to plot")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
