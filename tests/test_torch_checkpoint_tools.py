"""The port's checkpoint tools (``python -m sbmc_tpu_torch.export_params``
and ``python -m sbmc_tpu_torch.convert_checkpoint``) against the JAX
package's (``scripts/export_params.py``, ``sbmc_tpu/train/convert.py``), on
the CPU.

Tolerances: the tools move and cast arrays without arithmetic, so snapshots
and checkpoints are compared exactly (the float16 snapshot is the float32
parameters rounded once). A converted model's output is held to the JAX
model's through JAX's converter with ``test_torch_models.py``'s float32
tolerance, ``2e-5 + 2e-5 * |jax|`` (conv sums in other orders).
"""

import json
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.models import KPCN as JKPCN
from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.train import Checkpointer as JCheckpointer
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu.train import TrainState
from sbmc_tpu.train.convert import flax_to_torch_key, torch_state_dict_to_flax
from sbmc_tpu_torch import convert_checkpoint, export_params
from sbmc_tpu_torch.denoise import load_model
from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.nn.layers import WNConv2D
from sbmc_tpu_torch.params import export_jax_params, flatten, read_msgpack
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.train.convert import (load_reference_state_dict,
                                          reference_key_to_port)
from tests.test_torch_train import SMALL, _batch, _random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "weights", "flagship_f16")
META = {"arch": "sbmc", "kpcn_mode": False, "model_params": SMALL,
        "data_params": {"spp": 2, "mode": "sbmc"}}
STEP = 7

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _jax_script(*argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu", SBMC_NO_COMPILE_CACHE="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "export_params.py")]
        + list(argv), cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _tree(path):
    return flatten(read_msgpack(path))


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _jax_template(params):
    jiface = JInterface(JMultisteps(**SMALL))
    params = jax.tree.map(jnp.asarray, params)
    return TrainState(params=params, opt_state=jiface.tx.init(params),
                      step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def jax_made(tmp_path_factory):
    """A JAX checkpoint of a small model at step 7, and the JAX script's
    export of it."""
    root = tmp_path_factory.mktemp("ckpt_tools")
    params = _random_params(JMultisteps(**SMALL), _batch(
        np.random.RandomState(0)), seed=1)
    state = _jax_template(params).replace(
        step=jnp.asarray(STEP, jnp.int32))
    src = str(root / "jax_ckpt")
    JCheckpointer(src, meta=META).save(state, STEP)
    snap = str(root / "jax_snap")
    _jax_script("export", src, snap)
    return dict(params=params, src=src, snap=snap)


def test_export_is_the_jax_scripts_export(jax_made, tmp_path):
    dst = str(tmp_path / "snap")
    assert export_params.main(export_params.parse_args(
        ["export", jax_made["src"], dst])) == STEP
    for name in ("snapshot.json", "meta.json"):
        with open(os.path.join(dst, name)) as f, \
                open(os.path.join(jax_made["snap"], name)) as g:
            assert json.load(f) == json.load(g), name
    got = _tree(os.path.join(dst, "params_f16.msgpack"))
    want = _tree(os.path.join(jax_made["snap"], "params_f16.msgpack"))
    _assert_trees_equal(got, want)
    assert len(got) > 30 and all(v.dtype == np.float16 for v in got.values())
    for k, v in flatten(jax_made["params"]).items():
        np.testing.assert_array_equal(got[k], v.astype(np.float16))


def test_import_resumes_in_jax(jax_made, tmp_path):
    """The port's import of the JAX script's snapshot is the state the JAX
    script's import builds (float32 params from the snapshot, optax's
    initial Adam state, the snapshot's step), and the JAX package resumes
    it."""
    dst = str(tmp_path / "ckpt")
    assert export_params.main(export_params.parse_args(
        ["import", jax_made["snap"], dst])) == STEP
    assert {"final.msgpack", "ckpt_%09d.msgpack" % STEP,
            "meta.json"} <= set(os.listdir(dst))
    rounded = jax.tree.map(lambda v: v.astype(np.float16).astype(
        np.float32), jax_made["params"])
    want = _jax_template(rounded).replace(step=jnp.asarray(STEP, jnp.int32))
    _assert_trees_equal(
        _tree(os.path.join(dst, "final.msgpack")),
        flatten(jax.tree.map(np.asarray,
                             flax.serialization.to_state_dict(want))))
    state, step = JCheckpointer(dst).load_latest(
        _jax_template(jax_made["params"]))
    assert step == STEP and int(state.step) == STEP
    for k, v in flatten(rounded).items():
        np.testing.assert_array_equal(np.asarray(flatten(state.params)[k]),
                                      v, err_msg=k)
    model, meta, step = load_model(dst, torch.device("cpu"))
    assert meta == json.loads(json.dumps(META)) and step == STEP


def test_export_prefers_the_tagged_checkpoint(tmp_path):
    """``--tag final`` exports the tagged checkpoint and its own step (the
    JAX script takes the tag for the step there and stops); without it, the
    latest numbered checkpoint."""
    src = str(tmp_path / "ckpt")
    ckpt = Checkpointer(src, meta=META)
    iface = export_params._interface(META)
    trees = {}
    for tag, step in (("final", 9), (None, 4)):
        with torch.no_grad():
            for p in iface.model.parameters():
                p.add_(1.0)
        iface.step = step
        ckpt.save(iface.state_tree(), step, tag=tag)
        trees[tag] = flatten(export_jax_params(iface.model))
    os.remove(os.path.join(src, "ckpt_000000009.msgpack"))
    for tag, step in (("final", 9), (None, 4)):
        dst = str(tmp_path / ("snap_%s" % tag))
        argv = ["export", src, dst] + (["--tag", tag] if tag else [])
        assert export_params.main(export_params.parse_args(argv)) == step
        with open(os.path.join(dst, "snapshot.json")) as f:
            assert json.load(f) == {"step": step, "dtype": "float16"}
        got = _tree(os.path.join(dst, "params_f16.msgpack"))
        _assert_trees_equal(got, {k: v.astype(np.float16)
                                  for k, v in trees[tag].items()})
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "meta.json").write_text(json.dumps(META))
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_params.export(str(empty), str(tmp_path / "x"))


def test_flagship_import_then_export_gives_back_the_snapshot(tmp_path):
    ckpt, snap = str(tmp_path / "ckpt"), str(tmp_path / "snap")
    assert export_params.import_(FLAGSHIP, ckpt) == 10500
    assert export_params.export(ckpt, snap) == 10500
    _assert_trees_equal(_tree(os.path.join(snap, "params_f16.msgpack")),
                        _tree(os.path.join(FLAGSHIP, "params_f16.msgpack")))
    for name in ("meta.json", "snapshot.json"):
        with open(os.path.join(snap, name)) as f, \
                open(os.path.join(FLAGSHIP, name)) as g:
            assert json.load(f) == json.load(g), name


# -- reference .pth conversion ------------------------------------------


def _reference_state_dict(template, weight_norm=True):
    """A state dict in the reference's names and layouts (OIHW weights,
    ``weight_g`` ``[out, 1, 1, 1]``), built from a JAX template tree through
    the JAX package's inverse name mapping."""
    sd = {}
    rng = np.random.RandomState(0)
    for path, arr in flatten(template["params"]).items():
        key = flax_to_torch_key(tuple(path.split("/")),
                                weight_norm=weight_norm)
        shape = np.shape(arr)
        if path.endswith("/v"):
            val = rng.randn(shape[3], shape[2], shape[0], shape[1])
        elif path.endswith("/g"):
            val = rng.rand(shape[0], 1, 1, 1) + 0.5
        else:
            val = rng.randn(*shape)
        sd[key] = torch.from_numpy(val.astype(np.float32))
    return sd


def _kpcn_batch(rng, n_in=9, h=20, w=20):
    return {k: rng.rand(1, c, h, w).astype(np.float32) for k, c in [
        ("kpcn_diffuse_in", n_in), ("kpcn_specular_in", n_in),
        ("kpcn_diffuse_buffer", 3), ("kpcn_specular_buffer", 3),
        ("kpcn_albedo", 3)]}


_MODELS = {
    "multisteps": (lambda: JMultisteps(**SMALL), lambda: Multisteps(**SMALL),
                   lambda rng: {k: v for k, v in _batch(
                       rng, bs=1, spp=2, mask=False).items()
                       if k in ("radiance", "features", "global_features")},
                   True),
    "kpcn": (lambda: JKPCN(n_in=9, ksize=3, depth=2, width=4),
             lambda: KPCN(n_in=9, ksize=3, depth=2, width=4), _kpcn_batch,
             False),
}


@pytest.mark.parametrize("name", list(_MODELS))
def test_converted_model_is_the_jax_converted_model(name):
    jmake, make, batch_of, wn = _MODELS[name]
    rng = np.random.RandomState(1)
    batch = {k: v.astype(np.float32) for k, v in batch_of(rng).items()}
    jm = jmake()
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    sd = _reference_state_dict(template, weight_norm=wn)
    jparams = torch_state_dict_to_flax(sd, template=template)
    model = load_reference_state_dict(make(), sd)
    # The same parameters as JAX's converter gives, in the flax layout.
    want = flatten(jax.tree.map(np.asarray, jparams))
    got = flatten(export_jax_params(model))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jout = np.asarray(jax.jit(jm.apply)(jparams, batch)["radiance"])
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    out = out["radiance"].numpy()
    assert out.shape == jout.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, jout, atol=2e-5, rtol=2e-5)


def test_weight_normed_conv_is_the_torch_weight_norm():
    """The reference's ``weight_norm`` conv, converted, computes the same
    output through the port's WNConv2D (same norm over the other dims)."""
    cin, cout, k = 5, 7, 3
    torch.manual_seed(0)
    conv = torch.nn.utils.weight_norm(
        torch.nn.Conv2d(cin, cout, k, padding=k // 2))
    holder = torch.nn.Module()
    holder.embedding_00 = torch.nn.Module()
    holder.embedding_00.prediction = WNConv2D(cin, cout, k)
    sd = {"embedding_00.prediction." + n: v
          for n, v in conv.state_dict().items()}
    assert sd["embedding_00.prediction.weight_g"].shape == (cout, 1, 1, 1)
    load_reference_state_dict(holder, sd)
    x = torch.rand(1, cin, 9, 11)
    with torch.no_grad():
        torch.testing.assert_close(holder.embedding_00.prediction(x),
                                   conv(x), atol=1e-5, rtol=1e-5)


def test_key_mapping():
    assert reference_key_to_port(
        "propagation_01.net.next_level.next_level.right.layer_2.layer.0."
        "weight_v") == "propagation_01.right_2.layer_2.v"
    assert reference_key_to_port("kernel_regressor.prediction.weight_g") \
        == "kernel_stage.kernel_regressor.prediction.g"
    assert reference_key_to_port("diffuse.layer_0.layer.0.weight") \
        == "diffuse.layer_0.v"
    for bad in ("optimizer.lr", "propagation_00.net.up.layer_0.bias",
                "embedding_00.layer_0.layer.0.weight_u"):
        with pytest.raises(ValueError):
            reference_key_to_port(bad)


@pytest.mark.parametrize("fault", ["shape", "missing", "extra"])
def test_mismatch_raises(fault):
    jm = JKPCN(n_in=9, ksize=3, depth=2, width=4)
    batch = _kpcn_batch(np.random.RandomState(2))
    sd = _reference_state_dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), batch), weight_norm=False)
    key = next(iter(sd))
    if fault == "shape":
        sd[key] = torch.zeros(1, 1, 1, 1)
    elif fault == "missing":
        del sd[key]
    else:
        sd["diffuse.layer_7.layer.0.bias"] = torch.zeros(4)
    with pytest.raises(ValueError, match=fault if fault != "shape"
                       else "shape mismatch"):
        load_reference_state_dict(KPCN(n_in=9, ksize=3, depth=2, width=4),
                                  sd)


def test_convert_checkpoint_cli_writes_what_jax_reads(tmp_path):
    rng = np.random.RandomState(3)
    jm = JMultisteps(**SMALL)
    batch = {k: v for k, v in _batch(rng, bs=1, spp=2, mask=False).items()
             if k in ("radiance", "features", "global_features")}
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    sd = _reference_state_dict(template)
    pth, meta = str(tmp_path / "model.pth"), str(tmp_path / "meta.json")
    torch.save({"model": sd, "epoch": 3}, pth)
    with open(meta, "w") as f:
        json.dump(META, f)
    out = str(tmp_path / "ckpt")
    convert_checkpoint.main(convert_checkpoint.parse_args([pth, meta, out]))
    state, step = JCheckpointer(out).load_latest(_jax_template(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), template)))
    assert step == 0 and int(state.step) == 0
    want = flatten(jax.tree.map(np.asarray, torch_state_dict_to_flax(
        sd, template=template)))
    got = flatten(jax.tree.map(np.asarray, state.params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
