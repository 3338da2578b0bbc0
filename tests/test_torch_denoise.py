"""The port's denoise CLI against ``scripts/denoise.py`` on the same
synthetic frame and JAX-written checkpoint, and the port's isolation from
JAX.

Tolerance for the EXRs: both scripts write half floats, and the float32
models differ by ~1e-6, which can move a value across one half rounding
boundary: ``|port - jax| <= 1e-3 + 2e-3 * |jax|`` (two half units).
"""

import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbmc_tpu.data.synthetic import generate_dataset
from sbmc_tpu.models import Multisteps
from sbmc_tpu.models.build import model_meta
from sbmc_tpu.train import Checkpointer, DenoiserInterface, TrainState
from sbmc_tpu.utils import exr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One thread per process under xdist (the CLI runs in subprocesses too).
THREADS = {"OMP_NUM_THREADS": "1"} if os.environ.get(
    "PYTEST_XDIST_WORKER") else {}
MODEL = dict(n_features=93, n_global_features=3, width=16,
             embedding_width=16, ksize=5, nsteps=2)


def _run(args, **env):
    proc = subprocess.run([sys.executable] + args, cwd=ROOT,
                          env=dict(os.environ, **THREADS, **env),
                          capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 64x64, 2-spp synthetic frame and a small random SBMC checkpoint
    written by the JAX package's Checkpointer."""
    root = tmp_path_factory.mktemp("denoise")
    data = str(root / "data")
    generate_dataset(data, n_scenes=1, ts=32, tiles_per_side=2, spp=2,
                     gt_spp=4, seed=11)
    model = Multisteps(**MODEL)
    rng = np.random.RandomState(12)
    batch = {"radiance": jnp.zeros((1, 2, 3, 16, 16)),
             "features": jnp.zeros((1, 2, 93, 16, 16)),
             "global_features": jnp.zeros((1, 3, 1, 1))}
    shapes = flax.core.unfreeze(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), batch))
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]) or 1)
                   ).astype(np.float32), shapes)
    state = TrainState(params=params,
                       opt_state=DenoiserInterface(model).tx.init(params),
                       step=np.asarray(7, np.int32))
    ckpt = str(root / "ckpt")
    meta = model_meta(False, MODEL, {"spp": 2, "mode": "sbmc"})
    Checkpointer(ckpt, meta=meta).save(state, 7)
    return root, data, ckpt


FLAGS = ["--tile_size", "40", "--tile_pad", "8"]


def test_port_cli_matches_jax_cli(setup):
    root, data, ckpt = setup
    jout, tout = str(root / "jax.exr"), str(root / "port.exr")
    _run(["scripts/denoise.py", "--input", data, "--checkpoint", ckpt,
          "--output", jout, "--num_devices", "1", "--uniform_tiles"] + FLAGS,
         JAX_PLATFORMS="cpu")
    _run(["-m", "sbmc_tpu_torch.denoise", "--input", data, "--checkpoint",
          ckpt, "--output", tout, "--device", "cpu", "--uniform_tiles"]
         + FLAGS)
    want, got = exr.read(jout), exr.read(tout)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=2e-3)
    assert os.path.exists(tout.replace(".exr", ".png"))


def test_ragged_tiles_match_uniform_tiles(setup):
    """With the same tile grid (64 = 2 * 8 + 2 * 24), the ragged path and
    the uniform path with float32 transfer compute the same tiles and own
    the same pixels, so their frames are equal."""
    import torch
    from sbmc_tpu_torch import denoise
    if THREADS:
        torch.set_num_threads(1)
    root, data, ckpt = setup
    outs = []
    for tag, extra in (("r", []), ("u", ["--uniform_tiles",
                                         "--f32_transfer"])):
        path = str(root / f"port_{tag}.exr")
        res = denoise.main(denoise.parse_args(
            ["--input", data, "--checkpoint", ckpt, "--output", path,
             "--device", "cpu"] + FLAGS + extra))
        assert res[0]["tiles"] == 4 and res[0]["ms"] > 0
        outs.append(exr.read(path))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("extra", [[], ["--uniform_tiles"]],
                         ids=["ragged", "uniform"])
def test_trace_writes_a_chrome_trace(setup, tmp_path, extra):
    """``--trace DIR`` records the first scene's tiles: a Chrome trace with
    the model's convolutions in it, and the same frame as without it."""
    import json

    import torch
    from sbmc_tpu_torch import denoise
    if THREADS:
        torch.set_num_threads(1)
    _, data, ckpt = setup
    frames = []
    for trace in (None, str(tmp_path / "trace")):
        out = str(tmp_path / ("traced" if trace else "plain") / "a.exr")
        denoise.main(denoise.parse_args(
            ["--input", data, "--checkpoint", ckpt, "--output", out,
             "--device", "cpu"] + FLAGS + extra
            + (["--trace", trace] if trace else [])))
        frames.append(exr.read(out))
    np.testing.assert_array_equal(frames[0], frames[1])
    assert os.listdir(tmp_path / "trace") == [denoise.TRACE_FILE]
    with open(tmp_path / "trace" / denoise.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("convolution" in n for n in names), sorted(names)[:20]


def test_cli_refuses_missing_cuda_and_random_weights(setup, tmp_path,
                                                     monkeypatch):
    import torch
    from sbmc_tpu_torch import denoise
    _, data, ckpt = setup
    args = denoise.parse_args(["--input", data, "--checkpoint", ckpt,
                               "--output", str(tmp_path / "o.exr")])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise.main(args)
    empty = tmp_path / "empty"
    empty.mkdir()
    with open(os.path.join(ckpt, "meta.json")) as f:
        (empty / "meta.json").write_text(f.read())
    args = denoise.parse_args(["--input", data, "--checkpoint", str(empty),
                               "--output", str(tmp_path / "o.exr"),
                               "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        denoise.main(args)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax,
    flax and sbmc_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sbmc_tpu_torch\n"
        "for m in pkgutil.walk_packages(sbmc_tpu_torch.__path__, "
        "'sbmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sbmc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('sbmc_tpu_torch')]))\n")
    out = _run(["-c", code], PYTHONPATH=ROOT)
    assert int(out.stdout.strip()) >= 20
