"""The port's evaluation path against the JAX package's: the metrics and
their files (``sbmc_tpu_torch.evaluation`` against ``sbmc_tpu.evaluation``,
which writes with pandas), the ``compute_metrics`` and ``denoise_baselines``
CLIs, and ``python -m sbmc_tpu_torch.eval_suite`` end to end against
``scripts/eval_suite.py`` on the same scenes and checkpoint.

Tolerances:

- metrics, SSIM and the per-scene CSV: exact (the same numpy arithmetic;
  the files are compared byte for byte). The stats means within ``1e-12``
  relative (pandas and numpy sum in other orders); the LaTeX table is the
  same text.
- ``eval_suite``'s ``metrics.csv``: every value within ``5e-6 + 1e-4 *
  |jax|`` of the script's (both print six decimals; SBMC's float32 convs
  and the baselines' exp, solves and reductions round otherwise in the two
  frameworks, which moves a PSNR by ~3e-5 dB). The SBMC and input columns
  are the same text; the EXRs of the ground truth and the input are equal,
  SBMC's within two half-float units (``1e-3 + 2e-3 * |jax|``, as
  tests/test_torch_denoise.py holds the denoise CLI).
"""

import ast
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sbmc_tpu import evaluation as jeval
from sbmc_tpu_torch import compute_metrics, denoise_baselines, eval_suite
from sbmc_tpu_torch import evaluation
from sbmc_tpu_torch.comparisons import denoise_buffers
from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.models.build import model_meta
from sbmc_tpu_torch.train import DenoiserInterface
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils import exr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = {"OMP_NUM_THREADS": "1"} if os.environ.get(
    "PYTEST_XDIST_WORKER") else {}
if THREADS:
    torch.set_num_threads(1)
MODEL = dict(n_features=93, n_global_features=3, width=16,
             embedding_width=16, ksize=5, nsteps=2)


def _images(seed, h=30, w=34):
    rng = np.random.RandomState(seed)
    ref = rng.rand(h, w, 3).astype(np.float32)
    im = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, None).astype(
        np.float32)
    return im, ref


def test_metrics_match_jax():
    im, ref = _images(0)
    ref[0, 0] = np.nan  # rmse prunes NaNs
    for name, op in evaluation.METRIC_OPS.items():
        assert op(im, ref) == jeval.METRIC_OPS[name](im, ref) or (
            np.isnan(op(im, ref)) and np.isnan(jeval.METRIC_OPS[name](im,
                                                                      ref)))
    assert evaluation.METRIC_LABELS == jeval.METRIC_LABELS
    assert list(evaluation.METRIC_OPS) == list(jeval.METRIC_OPS)
    for name in ("sbmc_4spp", "8spp_ours", "16spp"):
        for m in (name, " %s " % name):
            if name.startswith("sbmc"):
                with pytest.raises(ValueError, match="spp format"):
                    evaluation._get_spp(m)
            else:
                assert evaluation._get_spp(m) == jeval._get_spp(m)


def test_ssim_golden_values():
    """The golden values of the JAX package's SSIM tests (an independent
    sliding-window implementation of the legacy-skimage protocol)."""
    rng = np.random.RandomState(0)
    a = rng.rand(20, 26, 3)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    c = np.clip(0.7 * a + 0.1, 0, 1)
    g = rng.rand(18, 22)
    assert abs(evaluation.ssim(a, b) - 0.953023341255) < 1e-9
    assert abs(evaluation.ssim(a, c) - 0.936004998831) < 1e-9
    assert abs(evaluation.ssim(g, np.roll(g, 1, axis=0))
               - 0.020436277501) < 1e-9
    assert abs(evaluation.ssim(a, a) - 1.0) < 1e-12
    assert evaluation.ssim(a, b) == jeval.ssim(a, b)


@pytest.fixture
def folders(tmp_path):
    """References of two scenes and three methods' outputs; one output is
    all zeros, so its scene is invalid and the stats prune it."""
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    methods = [tmp_path / d for d in ("4spp_input", "4spp_ours", "8spp_nfor")]
    for m in methods:
        m.mkdir()
    scenes = ["a.exr", "b.exr"]
    for i, scene in enumerate(scenes):
        for j, m in enumerate(methods):
            im, ref = _images(10 * i + j)
            if j == 0:
                exr.write(str(ref_dir / scene), ref, pixel_type="float")
            if i == 1 and j == 2:
                im = np.zeros_like(im)
            exr.write(str(m / scene), im, pixel_type="float")
    (tmp_path / "scenes.txt").write_text("\n".join(scenes) + "\n")
    return tmp_path, [str(m) for m in methods]


def test_compute_stats_and_latex_files_match_jax(folders):
    root, methods = folders
    got_csv, want_csv = str(root / "port.csv"), str(root / "jax.csv")
    rows = evaluation.compute(str(root / "ref"), got_csv, methods,
                              [str(root / "scenes.txt")], pad=3)
    jeval.compute(str(root / "ref"), want_csv, methods,
                  [str(root / "scenes.txt")], pad=3)
    with open(got_csv) as f, open(want_csv) as g:
        assert f.read() == g.read()
    assert len(rows) == 6 and [r["valid"] for r in rows].count(False) == 1
    assert evaluation.read_csv(want_csv) == rows

    mean_rows, std_rows = evaluation.stats([got_csv, want_csv],
                                           str(root / "port_stats.csv"))
    jmean, jstd = jeval.stats([got_csv, want_csv],
                              str(root / "jax_stats.csv"))
    for got, want in ((mean_rows, jmean), (std_rows, jstd),
                      (evaluation.read_csv(str(root / "port_stats.csv")),
                       jmean)):
        assert [list(r) for r in got] == [list(want.columns)] * len(want)
        for r, (_, w) in zip(got, want.iterrows()):
            for k, v in r.items():
                if isinstance(v, str):
                    assert v == w[k]
                else:
                    np.testing.assert_allclose(v, w[k], rtol=1e-12)
    # Scene "b" is invalid for one method, so only "a" is scored; the two
    # files are copies, so each group's std is 0, and with one file it is
    # the sample std of one value: NaN, as in pandas.
    assert len(mean_rows) == 3 and std_rows[0]["mse"] == 0.0
    _, one_std = evaluation.stats([got_csv], str(root / "one.csv"))
    assert np.isnan(one_std[0]["mse"])
    assert np.isnan(jeval.stats([want_csv], str(root / "jone.csv"))[1]
                    ["mse"][0])
    assert evaluation.to_latex(mean_rows) == jeval.to_latex(jmean)


def test_compute_metrics_cli(folders):
    root, methods = folders
    out = str(root / "cli.csv")
    args = compute_metrics.parse_args(
        [str(root / "ref"), out, "--methods"] + methods
        + ["--scenes", "a.exr", "b.exr", "--pad", "3", "--stats",
           str(root / "s.csv"), "--latex", str(root / "t.tex")])
    rows = compute_metrics.main(args)
    jeval.compute(str(root / "ref"), str(root / "j.csv"), methods,
                  ["a.exr", "b.exr"], pad=3)
    assert evaluation.read_csv(out) == rows == evaluation.read_csv(
        str(root / "j.csv"))
    jmean, _ = jeval.stats([str(root / "j.csv")], str(root / "js.csv"))
    with open(str(root / "t.tex")) as f:
        assert f.read() == jeval.to_latex(jmean)
    with pytest.raises(RuntimeError, match=".csv output"):
        evaluation.compute(str(root / "ref"), str(root / "x.txt"), methods,
                           ["a.exr"])


def _run(args, **env):
    proc = subprocess.run([sys.executable] + args, cwd=ROOT,
                          env=dict(os.environ, **THREADS, **env),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two synthetic 64x64 scenes at 4 spp and a small random SBMC
    checkpoint written by the port in the JAX package's format."""
    root = tmp_path_factory.mktemp("eval")
    data = str(root / "data")
    generate_dataset(data, n_scenes=2, ts=32, tiles_per_side=2, spp=4,
                     gt_spp=8, seed=3)
    torch.manual_seed(0)
    iface = DenoiserInterface(Multisteps(**MODEL), device="cpu")
    ckpt = str(root / "ckpt")
    Checkpointer(ckpt, meta=model_meta(False, MODEL, {"spp": 4,
                                                      "mode": "sbmc"})
                 ).save(iface.state_tree(), 3)
    return root, data, ckpt


FLAGS = ["--tile_size", "48", "--tile_pad", "8", "--pad", "4"]


def test_eval_suite_matches_jax_script(scenes):
    root, data, ckpt = scenes
    jout, tout = str(root / "jax"), str(root / "port")
    _run(["scripts/eval_suite.py", "--data", data, "--checkpoint", ckpt,
          "--output", jout] + FLAGS, JAX_PLATFORMS="cpu")
    res = eval_suite.main(eval_suite.parse_args(
        ["--data", data, "--checkpoint", ckpt, "--output", tout, "--device",
         "cpu", "--png"] + FLAGS))
    with open(os.path.join(jout, "metrics.csv")) as f:
        want = list(csv.DictReader(f))
    with open(os.path.join(tout, "metrics.csv")) as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        assert g["scene"] == w["scene"]
        for k in w:
            if k == "scene":
                continue
            if k.startswith(("input_", "ours_")):
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           atol=5e-6, rtol=1e-4, err_msg=k)
    assert res["methods"] == ["input", "ours", "nlm", "cbf", "rpf", "nfor"]
    assert res["tiles"] == {"ours": 4}
    assert all(len(v) == 2 and min(v) > 0 for v in res["ms"].values())
    for d in ["gt"] + ["4spp_" + m for m in res["methods"]]:
        for scene in ("scene_0000", "scene_0001"):
            a = exr.read(os.path.join(tout, d, scene + ".exr"))
            b = exr.read(os.path.join(jout, d, scene + ".exr"))
            assert a.shape == b.shape == (64, 64, 3)
            if d in ("gt", "4spp_input"):
                np.testing.assert_array_equal(a, b)
            elif d == "4spp_ours":
                # Half floats: two units, as tests/test_torch_denoise.py.
                np.testing.assert_allclose(a, b, atol=1e-3, rtol=2e-3)
    with open(os.path.join(tout, "metrics.md")) as f, \
            open(os.path.join(jout, "metrics.md")) as g:
        assert f.readline() == g.readline()
    with open(os.path.join(tout, "png", "columns.txt")) as f:
        assert f.read().split() == ["gt"] + res["methods"]
    assert os.path.getsize(os.path.join(tout, "png", "scene_0000.png")) > 0


def test_entry_points_need_cuda_unless_told(scenes, monkeypatch, tmp_path):
    _, data, ckpt = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = eval_suite.parse_args(["--data", data, "--checkpoint", ckpt,
                                  "--output", str(tmp_path)])
    assert args.device == "cuda" and args.tile_size == 512
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_suite.main(args)
    args = denoise_baselines.parse_args(["--input", data, "--output",
                                         str(tmp_path / "o.exr")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_baselines.main(args)


def test_denoise_baselines_cli(scenes, tmp_path):
    """One EXR (and PNG) per scene, suffixed by the scene's name, holding the
    baseline's output in half floats."""
    _, data, _ = scenes
    out = str(tmp_path / "o" / "cbf.exr")
    res = denoise_baselines.main(denoise_baselines.parse_args(
        ["--input", data, "--output", out, "--method", "cbf", "--spp", "4",
         "--device", "cpu"]))
    raw = FullImagesDataset(data, mode=TilesDataset.RAW_MODE, spp=4)
    assert [r["scene"] for r in res] == ["scene_0000", "scene_0001"]
    for i, r in enumerate(res):
        assert r["output"].endswith("cbf_%s.exr" % r["scene"])
        want = denoise_buffers(raw[i]["features"], raw.labels, method="cbf",
                               device="cpu")
        np.testing.assert_array_equal(
            exr.read(r["output"]),
            want.transpose(1, 2, 0).astype(np.float16).astype(np.float32))
        assert os.path.exists(r["output"].replace(".exr", ".png"))
    with pytest.raises(SystemExit, match=".exr"):
        denoise_baselines.main(denoise_baselines.parse_args(
            ["--input", data, "--output", "x.png", "--device", "cpu"]))


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    anything of sbmc_tpu (a static check of every import statement)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "sbmc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "sbmc_tpu")]
    assert not bad, bad
