"""The port's Multisteps against the JAX model, on the same inputs and
weights (small random models, and the committed flagship checkpoint).

Tolerances:
- float32: ``2e-5 + 2e-5 * |jax|`` (conv sums in other orders; measured
  errors are ~1e-6).
- the flagship with its own bfloat16 convs: max abs 3e-2 and mean abs 4e-3
  on outputs of order 1. Both frameworks round every conv output to bf16,
  at places that differ by one unit; the JAX model's own bf16-vs-f32 drift
  on this input is of the same size (~1.7e-2 max, ~2.3e-3 mean).
- bf16 splat logits (``kernel_dtype``): the two models may round a logit
  to different bf16 neighbours, which moves a pixel by up to ~1e-3.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.models.build import build_model as jbuild
from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import flatten, load_jax_params
from sbmc_tpu_torch.train.checkpointer import Checkpointer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "flagship_f16")


def _batch(rng, bs=2, spp=3, nf=8, ngf=3, h=19, w=22):
    return {"radiance": rng.rand(bs, spp, 3, h, w).astype(np.float32),
            "features": rng.rand(bs, spp, nf, h, w).astype(np.float32),
            "global_features": rng.rand(bs, ngf, 1, 1).astype(np.float32)}


def _random_params(module, batch, seed):
    """Flax variables of ``module`` redrawn from a numpy seed (shapes from
    an abstract init, which compiles nothing)."""
    rng = np.random.RandomState(seed)
    shapes = flax.core.unfreeze(jax.eval_shape(
        module.init, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()}))

    def redraw(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = redraw(v)
            elif k == "g":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = (rng.randn(*v.shape) / np.sqrt(
                    np.prod(v.shape[:-1]))).astype(np.float32)
        return out
    return redraw(shapes)


def _both(jmodel, tmodel, params, batch):
    jout = jmodel.apply(params, {k: jnp.asarray(v) for k, v in batch.items()})
    load_jax_params(tmodel, params)
    with torch.inference_mode():
        tout = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    return ({k: np.asarray(v, np.float32) for k, v in jout.items()},
            {k: v.float().numpy() for k, v in tout.items()})


def _close(got, want, atol=2e-5, rtol=2e-5):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


SMALL = dict(n_features=8, n_global_features=3, width=16, embedding_width=16,
             ksize=5, nsteps=2)


@pytest.mark.parametrize("kw", [{}, {"pixel": True}, {"return_kernels": True}],
                         ids=["default", "pixel", "kernels"])
def test_small_multisteps_matches_jax(kw):
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    batch["sample_mask"] = np.array([[True, False, True],
                                     [True, True, True]])
    jm = JMultisteps(**SMALL, **kw)
    params = _random_params(jm, batch, seed=1)
    jout, tout = _both(jm, Multisteps(**SMALL, **kw), params, batch)
    assert tout["radiance"].shape == (2, 3, 15, 18)
    _close(tout["radiance"], jout["radiance"])
    if kw.get("return_kernels"):
        _close(tout["kernels"], jout["kernels"], atol=1e-4, rtol=1e-5)


def test_small_multisteps_bf16_logits():
    rng = np.random.RandomState(2)
    batch = _batch(rng, bs=1, spp=2)
    jm = JMultisteps(**SMALL, kernel_dtype="bfloat16")
    params = _random_params(jm, batch, seed=3)
    jout, tout = _both(jm, Multisteps(**SMALL, kernel_dtype="bfloat16"),
                       params, batch)
    _close(tout["radiance"], jout["radiance"], atol=2e-3, rtol=0)


def test_masked_sample_leaves_the_state_whole():
    """A masked sample slot contributes nothing: the output equals the
    output without that sample."""
    rng = np.random.RandomState(4)
    batch = _batch(rng, bs=1, spp=3)
    model = Multisteps(**SMALL)
    masked = dict(batch, sample_mask=np.array([[True, True, False]]))
    dropped = {k: (v[:, :2] if k in ("radiance", "features") else v)
               for k, v in batch.items()}
    with torch.inference_mode():
        a = model({k: torch.from_numpy(v) for k, v in masked.items()})
        b = model({k: torch.from_numpy(v) for k, v in dropped.items()})
    torch.testing.assert_close(a["radiance"], b["radiance"], atol=1e-6,
                               rtol=1e-6)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="slice 3"):
        build_model({"arch": "kpcn", "model_params": {}})
    with pytest.raises(NotImplementedError, match="slice 3"):
        build_model({"arch": "lbf", "model_params": {}})
    with pytest.raises(ValueError):
        Multisteps(**dict(SMALL, ksize=4))
    model = Multisteps(**SMALL, splat=False)
    batch = _batch(np.random.RandomState(5), bs=1, spp=1)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="slice 3"):
        model({k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(RuntimeError, match="inference_mode"):
        model.splat = True
        model({k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def flagship():
    meta = Checkpointer.load_meta(FLAGSHIP)
    tree, step = Checkpointer(FLAGSHIP).load_params()
    return meta, tree, step


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """A 48x48, 2-spp synthetic tile through the port's data path."""
    root = str(tmp_path_factory.mktemp("frame"))
    generate_dataset(root, n_scenes=1, ts=48, tiles_per_side=1, spp=2,
                     gt_spp=2, seed=7)
    item = FullImagesDataset(root, spp=2)[0]
    return {k: item[k][None] for k in ("radiance", "features")} | {
        "global_features": item["global_features"][None]}


def test_flagship_leaves_all_map(flagship):
    meta, tree, step = flagship
    assert step == 10500
    leaves = flatten(tree["params"])
    assert len(leaves) == 171
    model = load_jax_params(build_model(meta), tree)
    assert sum(1 for _ in model.parameters()) == 171
    name, leaf = "kernel_stage/kernel_regressor/prediction/v", None
    leaf = leaves[name]
    assert leaf.dtype == np.float16 and leaf.shape == (1, 1, 128, 441)
    p = model.kernel_stage.kernel_regressor.prediction.v
    np.testing.assert_array_equal(p.detach().numpy()[:, :, 0, 0],
                                  leaf[0, 0].T.astype(np.float32))


def test_flagship_leaf_mismatch_raises(flagship):
    meta, tree, _ = flagship
    params = dict(flatten(tree["params"]))
    model = build_model(meta)

    def nest(flat):
        out = {}
        for path, v in flat.items():
            d = out
            *head, last = path.split("/")
            for k in head:
                d = d.setdefault(k, {})
            d[last] = v
        return {"params": out}

    missing = dict(params)
    del missing["propagation_01/right_0/layer_1/g"]
    with pytest.raises(ValueError, match="missing.*right_0/layer_1/g"):
        load_jax_params(model, nest(missing))
    extra = dict(params, **{"embedding_00/layer_9/bias": np.zeros(3)})
    with pytest.raises(ValueError, match="unexpected.*layer_9"):
        load_jax_params(model, nest(extra))
    wrong = dict(params, **{"embedding_00/layer_0/bias": np.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(model, nest(wrong))


def test_checkpoint_dir_without_weights_raises(tmp_path):
    (tmp_path / "meta.json").write_text('{"model_params": {}}')
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).load_params()


@pytest.mark.parametrize("conv_dtype", [None, "bfloat16"])
def test_flagship_matches_jax(flagship, frame, conv_dtype):
    meta, tree, _ = flagship
    mp = dict(meta["model_params"], conv_dtype=conv_dtype)
    meta = dict(meta, model_params=mp)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    tree)
    jout, tout = _both(jbuild(meta), build_model(meta), params, frame)
    got, want = tout["radiance"], jout["radiance"]
    assert got.shape == (1, 3, 28, 28) and np.isfinite(got).all()
    if conv_dtype is None:
        _close(got, want)
    else:
        err = np.abs(got - want)
        assert err.max() <= 3e-2 and err.mean() <= 4e-3, (err.max(),
                                                          err.mean())
