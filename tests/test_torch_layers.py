"""The port's NN layers against the flax layers of ``sbmc_tpu.nn``, with
shared parameters (drawn from a seed with numpy and loaded into the port
through ``load_jax_params``, which also checks the name mapping).

Tolerances: float32 ``2e-5 + 2e-5 * |jax|`` (convolutions summing up to
2304 products in other orders). bfloat16 compute rounds every layer's
output to 8 mantissa bits, and the two frameworks may round a product
differently by one unit, which later layers carry on: the bf16 cases allow
``3 * 2^-8 * (1 + |jax|)`` for one conv and a mean error below 2^-8 for the
deeper stacks, with a max of 8 units (``2^-5 * (1 + |jax|)``).
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.nn import layers as jl
from sbmc_tpu_torch.nn import layers as tl
from sbmc_tpu_torch.params import load_jax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _random_params(module, x_nhwc, seed):
    """Flax variables of ``module`` with every leaf redrawn from a seed
    (g away from ||v||, so the weight norm is exercised)."""
    rng = np.random.RandomState(seed)
    # Shapes only: an eager flax init compiles every initialiser anew.
    tree = flax.core.unfreeze(jax.eval_shape(
        module.init, jax.random.PRNGKey(0), jnp.asarray(x_nhwc)))

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
    return redraw(tree)


def _run(jmod, tmod, x_nchw, seed):
    x_nhwc = x_nchw.transpose(0, 2, 3, 1)
    params = _random_params(jmod, x_nhwc, seed)
    want = np.asarray(jmod.apply(params, jnp.asarray(x_nhwc)),
                      np.float32).transpose(0, 3, 1, 2)
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nchw))
    return got, want


def _check(got, want, dtype, deep):
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    if dtype is None:
        assert np.all(err <= 2e-5 + 2e-5 * np.abs(want)), err.max()
    elif not deep:
        assert np.all(err <= 3 * 2.0 ** -8 * (1 + np.abs(want))), err.max()
    else:
        assert err.mean() <= 2.0 ** -8, err.mean()
        assert np.all(err <= 2.0 ** -5 * (1 + np.abs(want))), err.max()


DTYPES = [(None, None), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("ksize,cin,hw", [(1, 6, (13, 10)), (3, 6, (13, 10)),
                                          (3, 4, (7, 9))])
def test_wnconv2d_matches_flax(ksize, cin, hw, jdt, tdt):
    """1x1 convs as the JAX package writes them (VALID, lowered to a
    matmul) and 3x3 "same" convs."""
    x = np.random.RandomState(1).randn(2, cin, *hw).astype(np.float32)
    jmod = jl.WNConv2D(5, ksize, pad=ksize > 1, dtype=jdt)
    tmod = tl.WNConv2D(cin, 5, ksize, dtype=tdt)
    got, want = _run(jmod, tmod, x, seed=2)
    assert got.dtype == (tdt or torch.float32)
    _check(got, want, tdt, deep=False)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("ksize,activation,output_type",
                         [(1, "leaky_relu", "linear"),
                          (3, "relu", "leaky_relu"), (3, "tanh", "elu")])
def test_convchain_matches_flax(ksize, activation, output_type, jdt, tdt):
    x = np.random.RandomState(5).randn(2, 7, 11, 12).astype(np.float32)
    jmod = jl.ConvChain(9, ksize=ksize, width=8, depth=3,
                        pad=ksize > 1, activation=activation,
                        output_type=output_type, dtype=jdt)
    tmod = tl.ConvChain(7, 9, ksize=ksize, width=8, depth=3,
                        activation=activation, output_type=output_type,
                        dtype=tdt)
    got, want = _run(jmod, tmod, x, seed=6)
    _check(got, want, tdt, deep=True)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("hw", [(13, 10), (16, 16)])
def test_autoencoder_matches_flax(hw, jdt, tdt):
    """The propagation U-Net as Multisteps configures it, narrowed; 13x10
    exercises max-pool flooring and upsampling to an odd skip size."""
    x = np.random.RandomState(7).randn(1, 6, *hw).astype(np.float32)
    kw = dict(num_levels=3, increase_factor=2.0, num_convs=3, width=4,
              ksize=3, output_type="leaky_relu")
    jmod = jl.Autoencoder(5, dtype=jdt, pooling="max", **kw)
    tmod = tl.Autoencoder(6, 5, dtype=tdt, **kw)
    got, want = _run(jmod, tmod, x, seed=8)
    _check(got, want, tdt, deep=True)


def test_layer_names_follow_flax():
    tmod = tl.Autoencoder(3, 2, width=4, num_levels=2, num_convs=2)
    names = {n for n, _ in tmod.named_parameters()}
    assert "left_0.layer_0.v" in names and "right_0.prediction.g" in names
    assert "left_1.prediction.bias" in names and len(names) == 3 * 2 * 3
