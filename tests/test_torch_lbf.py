"""The port's LBF (learned bilateral filter) against the JAX model, on the
same numpy inputs and parameters.

Tolerances: float32 ``2e-5 + 2e-5 * |jax|`` (the window loop sums
``(2r+1)^2`` weights in the same order; the 1x1 convs in other orders);
bfloat16 convs round the statistics, the parameter network and the
projected range features to bfloat16, at places that may differ by one
step, and the filter's weights are exponentials of those, averaged over the
289-pixel window: max abs 2e-3, mean abs 2e-4 on outputs of order 0.5
(measured 2.7e-5 and 9.3e-6). One float32 train step: loss within 1e-5
relative, gradients within ``1e-6 + 1e-3 * |jax|``, as
tests/test_torch_train.py states them.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.models import LBF as JLBF
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu_torch.models import LBF
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import export_jax_params, flatten, load_jax_params
from sbmc_tpu_torch.train import DenoiserInterface

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(n_features=8, n_global_features=3, window_r=2, n_guides=4,
             width=8, depth=3)


def _batch(rng, bs=2, spp=3, h=11, w=13, masked=True):
    b = {"radiance": rng.rand(bs, spp, 3, h, w).astype(np.float32),
         "features": rng.rand(bs, spp, 8, h, w).astype(np.float32),
         "global_features": rng.rand(bs, 3, 1, 1).astype(np.float32),
         "target_image": rng.rand(bs, 3, h, w).astype(np.float32)}
    if masked:
        b["sample_mask"] = np.array([[True, True, False],
                                     [True, True, True]][:bs])
    return b


def _random_params(module, batch, seed):
    """Flax variables of ``module`` redrawn from a numpy seed; biases are
    drawn too, so ``guide_proj/bias`` is exercised."""
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


def _outputs(kw, batch, seed):
    jm = JLBF(**kw)
    params = _random_params(jm, batch, seed)
    want = np.asarray(jm.apply(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
                      ["radiance"], np.float32)
    tm = load_jax_params(LBF(**kw), params)
    with torch.inference_mode():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    return got["radiance"].float().numpy(), want


@pytest.mark.parametrize("masked", [True, False])
def test_small_lbf_matches_jax(masked):
    batch = _batch(np.random.RandomState(0), masked=masked)
    got, want = _outputs(SMALL, batch, seed=1)
    assert got.shape == want.shape == (2, 3, 7, 9)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("conv_dtype", [None, "bfloat16"])
def test_default_lbf_matches_jax(conv_dtype):
    """Default width, ``n_guides`` and window (radius 8) on a 20x21 tile;
    global features given flat."""
    batch = _batch(np.random.RandomState(2), bs=1, h=20, w=21, masked=False)
    batch["global_features"] = batch["global_features"].reshape(1, 3)
    kw = dict(n_features=8, n_global_features=3, conv_dtype=conv_dtype)
    got, want = _outputs(kw, batch, seed=3)
    assert got.shape == (1, 3, 4, 5) and np.isfinite(got).all()
    if conv_dtype is None:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        err = np.abs(got - want)
        assert err.max() <= 2e-3 and err.mean() <= 2e-4, (err.max(),
                                                          err.mean())


def test_lbf_names_errors_and_factory():
    model = build_model({"arch": "lbf", "model_params": SMALL})
    assert isinstance(model, LBF)
    names = {n for n, _ in model.named_parameters()}
    assert {"param_net.layer_0.v", "param_net.prediction.g",
            "guide_proj.kernel", "guide_proj.bias"} <= names
    assert len(names) == 11
    flat = flatten(export_jax_params(model)["params"])
    assert flat["guide_proj/kernel"].shape == (1, 1, 8, 4)   # HWIO
    assert flat["param_net/layer_0/v"].shape == (1, 1, 25, 8)
    small = {k: torch.zeros(1, 1, c, 4, 9) for k, c in
             (("radiance", 3), ("features", 8))}
    small["global_features"] = torch.zeros(1, 3, 1, 1)
    with pytest.raises(ValueError, match="larger than 4x4"):
        model(small)


def test_lbf_train_step_matches_jax():
    batch = _batch(np.random.RandomState(4))
    batch["features"] = batch["features"].astype(np.float16)
    jiface = JInterface(JLBF(**SMALL), lr=1e-3)
    params = _random_params(jiface.model, {
        k: v for k, v in batch.items()}, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    (jloss, (jrmse, jbase)), jgrads = jax.value_and_grad(
        jiface._losses, has_aux=True)(jparams, jiface._arrays_only(batch))
    iface = DenoiserInterface(load_jax_params(LBF(**SMALL), params), lr=1e-3,
                              device="cpu")
    metrics = iface.train_step(batch)
    for k, want in (("loss", jloss), ("rmse", jrmse), ("input_loss", jbase)):
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-5)
    saved = {n: p.grad.clone() for n, p in iface.model.named_parameters()}
    with torch.no_grad():
        for n, p in iface.model.named_parameters():
            p.copy_(saved[n])
    grads = flatten(export_jax_params(iface.model)["params"])
    jgrads = {k: np.asarray(v) for k, v in flatten(
        flax.serialization.to_state_dict(jgrads["params"])).items()}
    assert set(grads) == set(jgrads) and len(grads) == 11
    for path, want in jgrads.items():
        np.testing.assert_allclose(grads[path], want, atol=1e-6, rtol=1e-3,
                                   err_msg=path)
