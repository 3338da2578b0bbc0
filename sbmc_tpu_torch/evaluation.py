"""Offline quality evaluation over rendered ``.exr`` images (counterpart of
``sbmc_tpu/evaluation.py``; reference: sbmc/evaluation.py:32-310).

Computes MSE / relative MSE / DSSIM / L1 / relative L1 between method
outputs and references, excluding a border, writes per-scene rows to CSV and
mean/std aggregates. SSIM is computed in numpy (uniform 7x7 window, K1=0.01,
K2=0.03, channel-averaged) to match the legacy
``skimage.measure.compare_ssim(multichannel=True)`` the reference calls,
including its float-input convention ``data_range = 2``.

The JAX package writes its tables with pandas; this module writes the same
files with the ``csv`` module (a leading unnamed index column, floats as
``repr``, booleans as ``True``/``False``, NaN as an empty field) and the
LaTeX table by hand, so it runs where pandas is not installed. Tables are
lists of row dicts, their keys in column order.
"""

import csv
import math
import os
import re

import numpy as np

from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

__all__ = ["compute", "stats", "to_latex", "read_csv", "write_csv",
           "METRIC_OPS", "METRIC_LABELS", "ssim"]


def _mse(im, ref):
    return float(np.square(im - ref).mean())


def _rmse(im, ref, eps=1e-4):
    diff = np.square(im - ref) / (np.square(ref) + eps)
    diff = np.ravel(diff)
    diff = diff[~np.isnan(diff)]
    return float(diff.mean())


def _l1(im, ref):
    return float(np.abs(im - ref).mean())


def _rl1(im, ref, eps=1e-4):
    return float((np.abs(im - ref) / (np.abs(ref) + eps)).mean())


def _uniform_filter(x, win):
    """Separable uniform (box) filter with 'valid' output region."""
    c = np.cumsum(np.pad(x, [(1, 0), (0, 0), (0, 0)], mode="constant"),
                  axis=0)
    x = (c[win:] - c[:-win]) / win
    c = np.cumsum(np.pad(x, [(0, 0), (1, 0), (0, 0)], mode="constant"),
                  axis=1)
    return (c[:, win:] - c[:, :-win]) / win


def ssim(im, ref, win_size=7, k1=0.01, k2=0.03, data_range=2.0):
    """Mean structural similarity over channels (legacy-skimage style)."""
    im = np.asarray(im, np.float64)
    ref = np.asarray(ref, np.float64)
    if im.ndim == 2:
        im, ref = im[..., None], ref[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # Sample moments, like skimage's use_sample_covariance.
    n = win_size * win_size
    cov_norm = n / (n - 1)
    ux = _uniform_filter(im, win_size)
    uy = _uniform_filter(ref, win_size)
    uxx = _uniform_filter(im * im, win_size)
    uyy = _uniform_filter(ref * ref, win_size)
    uxy = _uniform_filter(im * ref, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    return float((num / den).mean())


def _dssim(im, ref):
    return 1.0 - ssim(im, ref)


METRIC_LABELS = {"mse": "MSE", "rmse": "rMSE", "ssim": "DSSIM",
                 "l1": r"$L_1$", "relative_l1": r"relative $L_1$"}

METRIC_OPS = {"mse": _mse, "rmse": _rmse, "ssim": _dssim, "l1": _l1,
              "relative_l1": _rl1}


def _get_spp(method_name):
    """Extract the spp count from a "<N>spp_<method>" directory name."""
    method_name = method_name.strip()
    m = re.match(r"^(\d+)spp(?:_(.*))?$", method_name)
    if not m:
        raise ValueError("unexpected spp format for '%s'" % method_name)
    spp = int(m.group(1))
    return m.group(2) or "input", spp


def _parse_list_or_txt(_input):
    if len(_input) == 1 and os.path.splitext(_input[0])[-1] == ".txt":
        with open(_input[0]) as fid:
            return [line.strip() for line in fid if line.strip()]
    return list(_input)


def _field(v):
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def write_csv(rows, path):
    """Write row dicts (keys in column order) as a CSV with a leading
    unnamed index column, the layout of ``DataFrame.to_csv``."""
    cols = list(rows[0]) if rows else []
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow([""] + cols)
        for i, row in enumerate(rows):
            out.writerow([str(i)] + [_field(row[c]) for c in cols])


def _value(s):
    if s in ("True", "False"):
        return s == "True"
    if s == "":
        return float("nan")
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def read_csv(path):
    """Row dicts of a CSV written by :func:`write_csv` (or by pandas with
    its index), the index column dropped and values typed back."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        cols = next(reader)[1:]
        return [dict(zip(cols, map(_value, r[1:]))) for r in reader]


def compute(ref_folder, output, methods, scenes, pad=21):
    """Compute metrics for each (method, scene) pair; write a CSV.

    Args:
      ref_folder: folder with reference ``.exr`` images.
      output: output ``.csv`` path.
      methods: folders with method outputs, named ``<N>spp_<method>``.
      scenes: scene ``.exr`` filenames (list or ``.txt``).
      pad: border pixels excluded from the metrics.

    Returns:
      the rows written, one dict per (scene, method).
    """
    scenes = _parse_list_or_txt(scenes)
    methods = _parse_list_or_txt(methods)
    if os.path.splitext(output)[-1] != ".csv":
        raise RuntimeError("Metric computation expects a .csv output path.")
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)

    LOG.info("Evaluating %d scenes and %d methods", len(scenes), len(methods))
    rows = []
    for scene in scenes:
        sname = os.path.splitext(scene)[0]
        ref = exr.read(os.path.join(ref_folder, scene))[..., :3]
        if ref.sum() == 0:
            raise ValueError("got an all zero reference image %s" % scene)
        if pad > 0:
            ref = ref[pad:-pad, pad:-pad, :]
        for m in methods:
            mname, spp = _get_spp(os.path.split(m)[-1])
            row = {"method": mname, "scene": sname, "spp": spp}
            try:
                im = exr.read(os.path.join(m, scene))[..., :3]
                if pad > 0:
                    im = im[pad:-pad, pad:-pad, :]
                if im.sum() == 0:
                    raise ValueError("all-zero output image")
                row["valid"] = True
                for k, op in METRIC_OPS.items():
                    row[k] = op(im, ref)
            except Exception as e:
                LOG.error("invalid %s/%s: %s", m, scene, e)
                row["valid"] = False
                for k in METRIC_OPS:
                    row[k] = -1.0
            rows.append(row)
    write_csv(rows, output)
    return rows


def _unique(values):
    return list(dict.fromkeys(values))


def _std(values):
    """Sample standard deviation (ddof 1; NaN for one value), as pandas'
    ``Series.std``."""
    if len(values) < 2:
        return float("nan")
    return float(np.std(values, ddof=1))


def stats(csv_files, output):
    """Aggregate per-scene CSVs into per-(spp, method) mean/std tables
    (invalid scenes pruned entirely, reference: sbmc/evaluation.py:139-180);
    writes the means to ``output``.

    Returns:
      ``(mean_rows, std_rows)``, each a list of dicts with the metric
      columns, then ``method`` and ``spp``.
    """
    rows = [r for p in csv_files for r in read_csv(p)]
    invalid = _unique(r["scene"] for r in rows if not r["valid"])
    if invalid:
        LOG.warning("%d invalid scenes %s", len(invalid), invalid)
    rows = [r for r in rows if r["scene"] not in invalid and r["valid"]]

    mean_rows, std_rows = [], []
    for spp in _unique(r["spp"] for r in rows):
        cur = [r for r in rows if r["spp"] == spp]
        for m in _unique(r["method"] for r in cur):
            mdata = [r for r in cur if r["method"] == m]
            mean = {k: float(np.mean([r[k] for r in mdata]))
                    for k in METRIC_OPS}
            std = {k: _std([r[k] for r in mdata]) for k in METRIC_OPS}
            for row, agg in ((mean, mean_rows), (std, std_rows)):
                row["method"] = m
                row["spp"] = spp
                agg.append(row)
    LOG.info("Averages:\n%s", "\n".join(
        " ".join("%s=%s" % (k, _field(v)) for k, v in r.items())
        for r in mean_rows))
    write_csv(mean_rows, output)
    return mean_rows, std_rows


def to_latex(mean_rows, path=None):
    """Render a mean-metrics table as LaTeX, in the layout of pandas'
    ``to_latex(index=False, float_format="%.5f")`` (the reference's legacy
    figure-table exporter role, scripts/figures/_legacy_big_metrics.py)."""
    metrics = [c for c in METRIC_LABELS if mean_rows and c in mean_rows[0]]
    cols = ["method", "spp"] + metrics
    align = "".join("l" if all(isinstance(r[c], str) for r in mean_rows)
                    else "r" for c in cols)

    def cell(v):
        if isinstance(v, (float, np.floating)):
            return "NaN" if math.isnan(v) else "%.5f" % v
        return str(v)

    lines = ["\\begin{tabular}{%s}" % align, "\\toprule",
             " & ".join(["method", "spp"] + [METRIC_LABELS[c]
                                             for c in metrics]) + " \\\\",
             "\\midrule"]
    lines += [" & ".join(cell(r[c]) for c in cols) + " \\\\"
              for r in mean_rows]
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    tex = "\n".join(lines)
    if path is not None:
        with open(path, "w") as f:
            f.write(tex)
    return tex
