"""The port's checkpoint probes (``python -m sbmc_tpu_torch.probe_vs_input``
and ``python -m sbmc_tpu_torch.kernel_grids``) against the JAX scripts
(``scripts/probe_vs_input.py``, ``scripts/figures/kernels.py``) run in this
process on the same data and weights, on the CPU: a small float32 model
saved by the port, and ``weights/flagship_f16`` (full width, bfloat16
convs) on small tiles (32x32, 2 spp) so that JAX's compile stays short.
The JAX scripts' scores and grids are read from their own calls of
``losses.tonemapped_relative_mse`` and ``kernels_to_image``.

Tolerances:

- scores of the small float32 model and of the input mean: ``1e-5``
  relative (float32 convs in other orders; the input mean is the same
  numpy arithmetic).
- scores of the flagship: ``FLAGSHIP_RTOL`` relative. Its bfloat16 convs
  round at places that differ by one unit in the two frameworks, which
  moves single outputs by up to 3e-2 (``test_torch_models.py``); the
  loss, a mean over the tile, moves by far less.
- kernel grids (small model, 16x16 crop, 2 spp): within ``1e-5``; the
  PNGs within one grey level. Grids of bfloat16 logits: the same bytes as
  the JAX script's numpy arithmetic on bfloat16 arrays.
"""

import contextlib
import io
import os
import re
import shutil
from types import SimpleNamespace

import imageio.v2 as imageio
import ml_dtypes
import numpy as np
import pytest
import torch

import sbmc_tpu.losses as jlosses
from sbmc_tpu_torch import kernel_grids, probe_vs_input
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.models.build import model_meta
from sbmc_tpu_torch.train import DenoiserInterface
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils.image import read_png
from tests.test_torch_figures import load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "weights", "flagship_f16")
SMALL = dict(n_features=93, n_global_features=3, width=16,
             embedding_width=16, ksize=5, nsteps=2)
RTOL = 1e-5
FLAGSHIP_RTOL = 2e-3
GRID_ATOL = 1e-5

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic scene of 2x2 tiles of 32x32 at 2 spp, and a small random
    SBMC checkpoint written by the port (step 5) in the JAX format."""
    root = tmp_path_factory.mktemp("probe")
    data = str(root / "data")
    generate_dataset(data, n_scenes=1, ts=32, tiles_per_side=2, spp=2,
                     gt_spp=4, seed=7)
    torch.manual_seed(0)
    iface = DenoiserInterface(Multisteps(**SMALL), device="cpu")
    ckpt = str(root / "ckpt")
    Checkpointer(ckpt, meta=model_meta(False, SMALL, {"spp": 2,
                                                      "mode": "sbmc"})
                 ).save(iface.state_tree(), 5)
    return root, data, ckpt


def _jax_probe(data, ckpt, tiles, monkeypatch):
    """The JAX script's scores: (model, input) pairs in its call order,
    and its printed text."""
    script = load_script("scripts/probe_vs_input.py", "_jax_probe")
    seen = []
    plain = jlosses.tonemapped_relative_mse

    def record(im, ref):
        v = plain(im, ref)
        seen.append(float(v))
        return v

    monkeypatch.setattr(jlosses, "tonemapped_relative_mse", record)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        script.main(SimpleNamespace(data=data, checkpoint=ckpt, spp=2,
                                    tiles=tiles))
    return seen[0::2], seen[1::2], log.getvalue()


def _port_probe(data, ckpt, tiles):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = probe_vs_input.main([data, ckpt, "--spp", "2", "--tiles",
                                   str(tiles), "--device", "cpu"])
    return res, log.getvalue()


def _lines(text):
    """The printed lines with the numbers and seconds masked."""
    return [re.sub(r"\d+\.\d{5}", "X", re.sub(r"\(\d+s\)", "(Ns)", ln))
            for ln in text.splitlines()]


@pytest.mark.parametrize("which", ["small", "flagship"])
def test_probe_scores_match_jax_script(setup, which, monkeypatch):
    _, data, ckpt = setup
    ckpt = ckpt if which == "small" else FLAGSHIP
    tiles = 3 if which == "small" else 2
    jm, ji, jlog = _jax_probe(data, ckpt, tiles, monkeypatch)
    res, plog = _port_probe(data, ckpt, tiles)
    assert res["tiles"] == ([0, 1, 3] if tiles == 3 else [0, 3])
    assert len(res["model"]) == len(jm) == tiles
    np.testing.assert_allclose(res["input"], ji, rtol=RTOL)
    np.testing.assert_allclose(res["model"], jm, rtol=RTOL if which ==
                               "small" else FLAGSHIP_RTOL)
    assert _lines(plog) == _lines(jlog)
    if which == "small":
        assert plog.splitlines()[0] == "loaded checkpoint step 5"


def test_probe_prefers_the_snapshot_and_refuses_empty(setup, tmp_path):
    """A directory with both a snapshot and a training checkpoint is read
    from the snapshot, as the JAX script reads it; one with neither
    exits."""
    _, data, ckpt = setup
    both = tmp_path / "both"
    shutil.copytree(ckpt, str(both))
    assert Checkpointer(str(both)).find()[1] == 5
    model = Multisteps(**SMALL)
    probe_vs_input.load_params(str(both), model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    from sbmc_tpu_torch.export_params import export
    export(ckpt, str(both))
    probe_vs_input.load_params(str(both), model)
    # The snapshot is the same weights rounded to float16.
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), before[k].numpy().astype(np.float16).astype(
                np.float32))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no checkpoint found"):
        probe_vs_input.load_params(str(empty), model)


def test_kernel_grids_match_jax_script(setup, monkeypatch):
    root, data, ckpt = setup
    script = load_script("scripts/figures/kernels.py", "_jax_kernels")
    jgrids, pgrids = [], []
    jplain, pplain = script.kernels_to_image, kernel_grids.kernels_to_image

    def jrec(k):
        g = jplain(k)
        jgrids.append(np.asarray(g, np.float32))
        return g

    def prec(k):
        g = pplain(k)
        pgrids.append(g.float().numpy())
        return g

    monkeypatch.setattr(script, "kernels_to_image", jrec)
    monkeypatch.setattr(kernel_grids, "kernels_to_image", prec)
    jout, pout = str(root / "kj"), str(root / "kp")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        script.main(SimpleNamespace(input=data, checkpoint=ckpt,
                                    output=jout, samples=4, crop=16))
        n = kernel_grids.main(["--input", data, "--checkpoint",
                               ckpt, "--output", pout, "--crop", "16",
                               "--device", "cpu"])
    jline, pline = log.getvalue().splitlines()
    assert n == len(jgrids) == len(pgrids) == 2
    assert pline == jline.replace(jout, pout)
    for got, want in zip(pgrids, jgrids):
        assert got.shape == want.shape == (16 * 5, 16 * 5)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRID_ATOL)
    for name in ("output.png", "kernels_sample00.png",
                 "kernels_sample01.png"):
        want = imageio.imread(os.path.join(jout, name))
        got = read_png(os.path.join(pout, name))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))


def test_kernel_grid_of_bf16_logits_is_the_jax_scripts():
    """bfloat16 logits: the grid and its 8-bit image in bfloat16
    arithmetic, byte for byte the JAX script's numpy on a bfloat16
    array."""
    script = load_script("scripts/figures/kernels.py", "_jax_kernels2")
    logits = torch.tensor(3 * np.random.RandomState(2).randn(25, 6, 7),
                          dtype=torch.float32).to(torch.bfloat16)
    want = script.kernels_to_image(
        logits.float().numpy().astype(ml_dtypes.bfloat16))
    got = kernel_grids.kernels_to_image(logits)
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(
        kernel_grids._u8(got),
        (np.clip(want, 0, 1) * 255).astype(np.uint8))


def test_kernel_grids_refuse_kpcn_and_missing_checkpoints(setup, tmp_path):
    """KPCN is refused as in the JAX script; a directory without a
    training checkpoint exits (the JAX script would carry on with random
    weights: a deliberate divergence)."""
    _, data, ckpt = setup
    kp = tmp_path / "kpcn"
    kp.mkdir()
    Checkpointer(str(kp), meta=model_meta(True, {}, {"spp": 2}))
    with pytest.raises(SystemExit, match="KPCN"):
        kernel_grids.main(["--input", data, "--checkpoint", str(kp),
                           "--output", str(tmp_path / "o"), "--device",
                           "cpu"])
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "meta.json").write_bytes(
        open(os.path.join(ckpt, "meta.json"), "rb").read())
    with pytest.raises(SystemExit, match="no training checkpoint"):
        kernel_grids.main(["--input", data, "--checkpoint", str(empty),
                           "--output", str(tmp_path / "o"), "--device",
                           "cpu"])
    with pytest.raises(SystemExit, match="no training checkpoint"):
        kernel_grids.main(["--input", data, "--checkpoint", FLAGSHIP,
                           "--output", str(tmp_path / "o"), "--device",
                           "cpu"])
