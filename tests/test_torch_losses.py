"""The port's losses and tonemap against ``sbmc_tpu.losses`` and the closed
forms of tests/test_losses.py.

Tolerance: ``1e-6 + 1e-6 * |jax|`` on values and gradients (float32
elementwise arithmetic and one mean, in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import losses as jlosses
from sbmc_tpu.utils.image import tonemap as jtonemap
from sbmc_tpu_torch import losses
from sbmc_tpu_torch.utils.image import tonemap

NAMES = ["relative_mse", "smape", "tonemapped_mse", "tonemapped_relative_mse"]
TOL = dict(atol=1e-6, rtol=1e-6)


def _one(v):
    return torch.full((1, 3, 1, 1), v, dtype=torch.float32)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradient_match_jax(name):
    rng = np.random.RandomState(0)
    # Some negative and some large values: the tonemap clamps and saturates.
    im = (2 * rng.randn(2, 3, 8, 9)).astype(np.float32)
    ref = np.abs(2 * rng.randn(2, 3, 8, 9)).astype(np.float32)
    jfn, tfn = getattr(jlosses, name), getattr(losses, name)
    jval, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(ref)))(
        jnp.asarray(im))
    tim = torch.from_numpy(im).requires_grad_()
    tval = tfn(tim, torch.from_numpy(ref))
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    np.testing.assert_allclose(tim.grad.numpy(), np.asarray(jgrad), **TOL)


def test_tonemap_matches_jax():
    x = np.linspace(-3, 50, 97).astype(np.float32).reshape(1, 1, 1, 97)
    np.testing.assert_allclose(tonemap(torch.from_numpy(x)).numpy(),
                               np.asarray(jtonemap(jnp.asarray(x))), **TOL)
    assert float(tonemap(torch.tensor(-5.0))) == 0.0


@pytest.mark.parametrize("name,im,ref,expected", [
    ("relative_mse", 0.5, 0.5, 0.0),
    ("relative_mse", 3.0, 2.0, 0.5 * 1.0 / (4.0 + 1e-2)),
    ("relative_mse", 1.0, 2.0, 0.5 * 1.0 / (4.0 + 1e-2)),
    ("smape", 3.0, 1.0, 2.0 / (1e-2 + 3.0 + 1.0)),
    ("tonemapped_mse", 1.0, 3.0, 0.5 * (0.5 - 0.75) ** 2),
    ("tonemapped_mse", -5.0, 0.0, 0.0),
    ("tonemapped_relative_mse", 1.0, 3.0,
     0.5 * (0.5 - 0.75) ** 2 / (0.75 ** 2 + 1e-2)),
])
def test_closed_forms(name, im, ref, expected):
    got = float(getattr(losses, name)(_one(im), _one(ref)))
    assert np.isclose(got, expected)


def test_smape_denominator_carries_no_gradient():
    im, ref = _one(3.0).requires_grad_(), _one(1.0)
    losses.smape(im, ref).backward()
    # d/d_im |im - ref| / denom with the denominator detached = 1 / denom.
    expected = 1.0 / (1e-2 + 3.0 + 1.0) / im.numel()
    np.testing.assert_allclose(im.grad.numpy(), expected, atol=1e-6)


def test_class_wrappers():
    im, ref = _one(1.0), _one(3.0)
    for cls, fn in ((losses.RelativeMSE, losses.relative_mse),
                    (losses.SMAPE, losses.smape),
                    (losses.TonemappedMSE, losses.tonemapped_mse),
                    (losses.TonemappedRelativeMSE,
                     losses.tonemapped_relative_mse)):
        assert float(cls()(im, ref)) == float(fn(im, ref))
    assert float(losses.RelativeMSE(eps=1.0)(im, ref)) == \
        float(losses.relative_mse(im, ref, eps=1.0))
