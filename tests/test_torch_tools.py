"""The port's host tools against the JAX scripts, on the CPU:

- NFOR's channel export (``sbmc_tpu_torch.denoise_nfor.bins2exr``) against
  ``scripts/denoise_nfor.py``'s on a synthetic scene, and the call of the
  ``denoiser`` binary through a mock executable (the binary is not in the
  repo);
- ``python -m sbmc_tpu_torch.visualize_dataset`` against
  ``scripts/visualize_dataset.py``, and the PNG writer's grey layouts
  against imageio;
- ``python -m sbmc_tpu_torch.metrics_report`` against
  ``scripts/figures/metrics_report.py`` on CSVs of the port's
  ``compute_metrics``;
- the log tools that need no copy (``scripts/plot_train_log.py``,
  ``judge_ab.py``, ``update_quality_md.py``) on a ``train_log.csv`` the
  port's trainer wrote and an ``eval_suite`` metrics CSV of the port.

Tolerances: none but one. The channel files hold the same float32 pixels
(the same numpy arithmetic on the same decoded samples) and are the same
bytes; the PNGs hold the same pixels; ``stats.tex`` is the same bytes, and
``stats.csv`` is the JAX script's byte for byte when pandas parses the
score CSVs exactly (with pandas' default parser, which is not correctly
rounded, its means move in the last digit: ``1e-14`` relative); each log
tool gives the same result on the port's files as on the JAX package's.
"""

import contextlib
import csv
import io
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from sbmc_tpu.train import callbacks as jcallbacks
from sbmc_tpu_torch import (compute_metrics, denoise_nfor, eval_suite,
                            metrics_report, train_cli, visualize_dataset)
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.models.build import model_meta
from sbmc_tpu_torch.train import DenoiserInterface
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.image import read_png, write_png
from tests.test_torch_figures import load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import judge_ab  # noqa: E402
import plot_train_log  # noqa: E402
import update_quality_md  # noqa: E402

NFOR_FILES = sorted(n + s + ".exr" for n in ("color", "diffuse", "specular",
                                             "albedo", "normal", "depth")
                    for s in ("", "A", "B", "Variance"))

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """One synthetic 32x32 scene (2x2 tiles of 16) at 4 spp."""
    data = str(tmp_path_factory.mktemp("tools") / "data")
    generate_dataset(data, n_scenes=1, ts=16, tiles_per_side=2, spp=4,
                     gt_spp=8, seed=11)
    return data


# --- item 7: NFOR through Tungsten -----------------------------------------

def test_bins2exr_matches_jax_script(scene, tmp_path):
    script = load_script("scripts/denoise_nfor.py", "_jax_nfor")
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    script.bins2exr(scene, jout, 4)
    denoise_nfor.bins2exr(scene, pout, 4)
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout)) == NFOR_FILES
    for name in NFOR_FILES:
        got = exr.read(os.path.join(pout, name))
        want = exr.read(os.path.join(jout, name))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want)
        with open(os.path.join(pout, name), "rb") as f, \
                open(os.path.join(jout, name), "rb") as g:
            assert f.read() == g.read(), name
    # The A and B halves average to the whole; variances are not negative.
    c, a, b = (exr.read(os.path.join(pout, "color%s.exr" % s))
               for s in ("", "A", "B"))
    np.testing.assert_allclose((a + b) / 2, c, rtol=1e-6, atol=1e-7)
    assert exr.read(os.path.join(pout, "depthVariance.exr")).min() >= 0


def _mock_denoiser(tmp_path):
    """An executable that records its arguments and the channel files it
    was given, in its output directory."""
    exe = tmp_path / "denoiser"
    exe.write_text('#!/bin/sh\nls "$1" > "$2/inputs.txt"\n'
                   'echo "$@" > "$2/args.txt"\n')
    exe.chmod(0o755)
    return str(exe)


def test_denoise_nfor_calls_the_denoiser_as_the_jax_script(scene, tmp_path):
    exe = _mock_denoiser(tmp_path)
    scene_dir = os.path.join(scene, "scene_0000")
    for side in ("jax", "port"):
        tmp, out = str(tmp_path / (side + "_tmp")), str(tmp_path / side)
        argv = [exe, scene_dir, out, "--tmp_dir", tmp, "--spp", "4"]
        if side == "jax":
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       SBMC_NO_COMPILE_CACHE="1")
            proc = subprocess.run(
                [sys.executable, os.path.join(SCRIPTS, "denoise_nfor.py")]
                + argv, env=env, capture_output=True, text=True,
                timeout=300)
            assert proc.returncode == 0, proc.stderr[-2000:]
        else:
            denoise_nfor.main(argv)
        # The temporary directory is gone; the binary saw the 24 files.
        assert not os.path.exists(tmp)
        with open(os.path.join(out, "inputs.txt")) as f:
            assert sorted(f.read().split()) == NFOR_FILES
        with open(os.path.join(out, "args.txt")) as f:
            args = f.read().split()
        assert args == [os.path.join(tmp, "exr_channels") + "/", out]


# --- item 8: dataset visualisation and the PNG writer -----------------------

def test_visualize_dataset_matches_jax_script(scene, tmp_path):
    script = load_script("scripts/visualize_dataset.py", "_jax_vis")
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    script.main(SimpleNamespace(data_dir=scene, output=jout, spp=2,
                                dump_features=True))
    visualize_dataset.main([scene, pout, "--spp", "2", "--dump_features"])
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(pout)) == names
    assert "0000_reference.png" in names and "0000_depth.png" in names
    kinds = set()
    for name in names:
        want = imageio.imread(os.path.join(jout, name))
        for got in (read_png(os.path.join(pout, name)),
                    imageio.imread(os.path.join(pout, name))):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        kinds.add((want.dtype.name, want.ndim))
    # 8-bit RGB images and 16-bit grey feature means.
    assert kinds == {("uint8", 3), ("uint16", 2)}


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_png_grey_layouts_read_back(tmp_path, dtype):
    """``write_png`` takes ``[h, w]`` uint8 and uint16 images as imageio
    writes them; the port's reader and imageio read back the same pixels,
    and imageio's own file of the image reads back as the port's."""
    top = np.iinfo(dtype).max + 1
    img = np.random.RandomState(8).randint(0, top, (9, 13)).astype(dtype)
    img[0, :2] = (0, top - 1)
    mine, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(mine, img)
    imageio.imwrite(theirs, img)
    for path in (mine, theirs):
        for got in (read_png(path), imageio.imread(path)):
            assert got.dtype == img.dtype
            np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError):
        write_png(mine, img.astype(np.float32))
    with pytest.raises(ValueError):
        write_png(mine, np.zeros((4, 4, 3), np.uint16))


# --- the port's train log and metrics CSVs ----------------------------------

@pytest.fixture(scope="module")
def train_log(scene, tmp_path_factory):
    """A ``train_log.csv`` written by the port's trainer (KPCN at depth 2,
    width 8, 8 steps logged each step), and the same rows written by the
    JAX package's ``ScalarLogCallback`` (its wall-clock stamps replayed)."""
    root = tmp_path_factory.mktemp("log")
    ckpt = str(root / "ck")
    train_cli.main(train_cli.parse_args(
        [scene, ckpt, "--spp", "4", "--ksize", "5", "--bs", "2",
         "--max_steps", "8", "--log_interval", "1", "--num_worker_threads",
         "1", "--device", "cpu", "--kpcn_mode", "--kpcn_depth", "2",
         "--kpcn_width", "8"]))
    port = os.path.join(ckpt, "train_log.csv")
    with open(port, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 8
    jax_log = str(root / "jax_train_log.csv")
    cb = jcallbacks.ScalarLogCallback(jax_log, interval=1)
    real_time = time.time
    try:
        for r in rows:
            time.time = lambda r=r: float(r["wall_time"])
            cb.batch_end(int(r["step"]), {k: float(v) for k, v in r.items()
                                          if k not in ("step", "wall_time")})
    finally:
        time.time = real_time
    return port, jax_log


def test_port_train_log_is_the_jax_layout(train_log):
    port, jax_log = train_log
    with open(port, "rb") as f, open(jax_log, "rb") as g:
        assert f.read() == g.read()
    with open(port) as f:
        assert f.readline().strip() == "step,loss,rmse,input_loss,wall_time"


def test_judge_ab_on_the_port_log(train_log):
    port, jax_log = train_log
    got, want = judge_ab.judge(port), judge_ab.judge(jax_log)
    assert got.pop("path") == port and want.pop("path") == jax_log
    assert got == want and "healthy" in got
    runs = []
    for path in (port, jax_log):
        proc = subprocess.run([sys.executable, os.path.join(
            SCRIPTS, "judge_ab.py"), path, "--json", "--min_rows", "4"],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode in (0, 1)
        runs.append((proc.returncode, proc.stdout.replace(path, "LOG")))
    assert runs[0] == runs[1]


def test_plot_train_log_on_the_port_log(train_log, tmp_path):
    port, jax_log = train_log
    assert plot_train_log.read_log(port) == plot_train_log.read_log(jax_log)
    cols = plot_train_log.read_log(port)
    assert cols["step"] == [float(s) for s in range(1, 9)]
    out = str(tmp_path / "curve.png")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        plot_train_log.main(SimpleNamespace(logs=[port, jax_log], output=out,
                                            ema=0.97, labels=["port",
                                                              "jax"]))
    assert log.getvalue().strip() == "wrote %s" % out
    img = imageio.imread(out)
    assert img.ndim == 3 and img.shape[0] > 100


@pytest.fixture(scope="module")
def eval_metrics(scene, tmp_path_factory):
    """``metrics.csv`` of the port's ``eval_suite`` on the scene (a small
    random SBMC checkpoint, the four baselines) and its rows."""
    root = tmp_path_factory.mktemp("evalm")
    model = dict(n_features=93, n_global_features=3, width=8,
                 embedding_width=8, ksize=5, nsteps=1)
    torch.manual_seed(0)
    ckpt = str(root / "ckpt")
    Checkpointer(ckpt, meta=model_meta(False, model, {"spp": 4,
                                                      "mode": "sbmc"})
                 ).save(DenoiserInterface(Multisteps(**model),
                                          device="cpu").state_tree(), 1)
    out = str(root / "ev")
    res = eval_suite.main(eval_suite.parse_args(
        ["--data", scene, "--checkpoint", ckpt, "--output", out,
         "--tile_size", "32", "--tile_pad", "8", "--pad", "4", "--device",
         "cpu"]))
    return os.path.join(out, "metrics.csv"), res


def test_update_quality_md_on_the_port_metrics(eval_metrics, tmp_path):
    path, res = eval_metrics
    methods, agg, n = update_quality_md.read_metrics(path)
    assert methods == res["methods"] and n == len(res["rows"]) == 1
    for m in methods:
        for suf, _, _ in update_quality_md.COLS:
            assert agg[m][suf] == pytest.approx(
                res["rows"][0]["%s_%s" % (m, suf)], abs=5e-7)
    results = tmp_path / "results"
    results.mkdir()
    (results / "metrics_4spp.csv").write_bytes(open(path, "rb").read())
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "update_quality_md.py"),
         "--results", str(results), "--out", str(tmp_path / "Q.md"),
         "--train_scenes", "1"], cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    text = (tmp_path / "Q.md").read_text()
    assert update_quality_md.table(methods, agg) in text
    assert "1 scenes, 4 spp input" in text
    assert ("SBMC beats NFOR" in text) or ("NFOR still leads" in text)


# --- item 13: the metrics report --------------------------------------------

@pytest.fixture
def scores(tmp_path):
    """Per-scene CSVs of the port's ``compute_metrics`` over two scenes and
    three methods, one output all zeros (its scene is pruned)."""
    rng = np.random.RandomState(12)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    methods = [tmp_path / d for d in ("4spp_input", "4spp_ours",
                                      "8spp_nfor")]
    for m in methods:
        m.mkdir()
    for i, name in enumerate(("a.exr", "b.exr", "c.exr")):
        ref = rng.rand(24, 26, 3).astype(np.float32)
        exr.write(str(ref_dir / name), ref, pixel_type="float")
        for j, m in enumerate(methods):
            im = np.clip(ref + rng.normal(0, 0.05 * (j + 1), ref.shape), 0,
                         None).astype(np.float32)
            if i == 2 and j == 1:
                im = np.zeros_like(im)
            exr.write(str(m / name), im, pixel_type="float")
    csvs = []
    for k, scenes in enumerate((["a.exr", "b.exr"], ["c.exr"])):
        out = str(tmp_path / ("scores%d.csv" % k))
        compute_metrics.main(compute_metrics.parse_args(
            [str(ref_dir), out, "--methods"] + [str(m) for m in methods]
            + ["--scenes"] + scenes + ["--pad", "2"]))
        csvs.append(out)
    return tmp_path, csvs


def _report(side, script, out, csvs, logs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if side == "jax":
            script.main(SimpleNamespace(output=out, scores=csvs,
                                        train_logs=logs))
        else:
            metrics_report.main([out, "--scores"] + csvs
                                + ["--train_logs"] + logs)
    return buf.getvalue().replace(out, "OUT")


def _same_bytes(a, b, name):
    with open(os.path.join(a, name), "rb") as f, \
            open(os.path.join(b, name), "rb") as g:
        return f.read() == g.read()


def test_metrics_report_matches_jax_script(scores, train_log, monkeypatch):
    """The same files and printed lines; ``stats.tex`` the same bytes.
    ``stats.csv`` holds the same rows and columns, its means within
    ``1e-14`` relative: pandas' default CSV parser (``float_precision
    "high"``) is not correctly rounded, so the JAX script's means may
    differ in the last digit from those of the exact values the port reads.
    With pandas reading exactly (``"round_trip"``) the script's
    ``stats.csv`` is the port's, byte for byte."""
    import pandas as pd
    root, csvs = scores
    port_log, _ = train_log
    script = load_script("scripts/figures/metrics_report.py", "_jax_report")
    jout, pout, exact = (str(root / d) for d in ("jax", "port", "exact"))
    assert _report("jax", script, jout, csvs, [port_log]) == _report(
        "port", script, pout, csvs, [port_log])
    names = ["error_distributions.png", "stats.csv", "stats.tex",
             "train_log_curves.png"]
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout)) == names
    assert _same_bytes(pout, jout, "stats.tex")
    got = pd.read_csv(os.path.join(pout, "stats.csv"), index_col=0,
                      float_precision="round_trip")
    want = pd.read_csv(os.path.join(jout, "stats.csv"), index_col=0,
                       float_precision="round_trip")
    assert list(got.columns) == list(want.columns) and len(got) == 3
    for col in got.columns:
        if got[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=1e-14)
        else:
            assert list(got[col]) == list(want[col])
    for name in ("error_distributions.png", "train_log_curves.png"):
        assert imageio.imread(os.path.join(pout, name)).shape == \
            imageio.imread(os.path.join(jout, name)).shape
    read_csv = pd.read_csv
    monkeypatch.setattr(pd, "read_csv", lambda *a, **k: read_csv(
        *a, float_precision="round_trip", **k))
    _report("jax", script, exact, csvs, [])
    assert _same_bytes(pout, exact, "stats.csv")
    assert _same_bytes(pout, exact, "stats.tex")


def test_metrics_report_needs_matplotlib(scores, monkeypatch):
    root, csvs = scores
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        metrics_report.main([str(root / "x"), "--scores"] + csvs)
