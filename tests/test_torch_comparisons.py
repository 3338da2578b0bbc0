"""The port's classical baselines (``sbmc_tpu_torch.comparisons``) against
``sbmc_tpu.comparisons`` on the same numpy inputs.

Tolerances:

- ``_shifted`` and ``_box_filter``: exact. Edge padding is data movement,
  and the port takes the box filter's prefix sums in the order XLA's CPU
  backend takes ``jnp.cumsum`` (blocks of 16).
- ``_mi_cells``: the histogram bins exact on the same pooled input (a
  truncation, so one rounding step apart would flip a bin); the mutual
  information within ``1e-6 + 1e-5 * |jax|`` (sums over 64 bin pairs, and
  logs, in another order).
- Each filter at shrunk radii on random inputs, and
  ``_regression_filter``'s candidates: ``2e-6 + 2e-5 * |jax|`` (float32 exp,
  batched 8x8 solves and reductions rounding otherwise; measured at most
  5e-7 absolute).
- ``denoise_buffers`` at the default radii on a synthetic 32x32 frame of
  real sample records: ``|port - jax| <= 1e-5 + 1e-4 * |jax|`` on all but
  1% of the values and at most 5e-3 anywhere. Two steps turn rounding into
  visible differences on a few pixels: NLM's patch distance divides by the
  variance, which is 0 where all samples agree, so the box filter cancels
  prefix sums of order 1e8 there; NFOR's per-pixel choice ``m < mse``
  between two candidates flips where their MSE estimates tie to rounding.
  RPF's bins can flip the same way. The test reports what it measured.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import comparisons as J
from sbmc_tpu_torch import comparisons as T
from sbmc_tpu_torch.data.datasets import TilesDataset
from sbmc_tpu_torch.data.synthetic import generate_dataset

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=2e-5)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def buffers():
    """Half buffers, variances and features of a 20x26 frame (odd sizes,
    the ragged RPF cell grid); values of order 1."""
    rng = np.random.RandomState(0)
    h, w = 20, 26
    a, b = (rng.rand(3, h, w).astype(np.float32) for _ in range(2))
    var = (0.01 + 0.05 * rng.rand(3, h, w)).astype(np.float32)
    feat = rng.rand(7, h, w).astype(np.float32)
    fvar = (1e-3 * rng.rand(7, h, w)).astype(np.float32)
    return a, b, var, feat, fvar


@pytest.mark.parametrize("r", [1, 3, 8])
def test_box_filter_and_shift_are_exact(r):
    rng = np.random.RandomState(r)
    # Magnitudes spread over 12 orders, as NLM's patch distances are.
    x = (rng.randn(3, 23, 37) * np.exp(4 * rng.randn(3, 23, 37))).astype(
        np.float32)
    np.testing.assert_array_equal(_np(T._box_filter(*_t(x), r)),
                                  _np(J._box_filter(jnp.asarray(x), r)))
    for dy, dx in ((0, 0), (r, 2 * r), (2 * r, 1)):
        np.testing.assert_array_equal(
            _np(T._shifted(*_t(x), dy, dx, r)),
            _np(J._shifted(jnp.asarray(x), dy, dx, r)))


@pytest.mark.parametrize("n", [5, 16, 17, 300, 2049])
def test_prefix_sum_is_xla_cumsum(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(2, n) * np.exp(3 * rng.randn(2, n))).astype(np.float32)
    np.testing.assert_array_equal(_np(T._prefix_sum(*_t(x))),
                                  _np(jnp.cumsum(jnp.asarray(x), axis=-1)))


def test_mi_cells_and_bins():
    rng = np.random.RandomState(1)
    hc, wc, q, n_bins = 3, 4, 6, 8
    pooled = rng.randn(hc * wc, q, 64).astype(np.float32)
    # Values on and next to the bin edges, where the truncation decides.
    pooled[0, 0, :9] = (np.arange(9) / n_bins - 0.5) * 4
    pooled[0, 1, :9] = np.nextafter(pooled[0, 0, :9], -np.inf)
    want = jnp.clip((jnp.asarray(pooled) / 4.0 + 0.5) * n_bins, 0,
                    n_bins - 1e-3).astype(jnp.int32)
    np.testing.assert_array_equal(_np(T._bins(*_t(pooled), n_bins)),
                                  np.asarray(want))
    np.testing.assert_allclose(
        _np(T._mi_cells(*_t(pooled), hc, wc, n_bins)),
        _np(J._mi_cells(jnp.asarray(pooled), hc, wc, n_bins)),
        atol=1e-6, rtol=1e-5)


def test_nlm_matches_jax(buffers):
    a, b, var, _, _ = buffers
    np.testing.assert_allclose(
        _np(T.nlm_denoise(*_t(a, b, var), patch_r=2, window_r=3)),
        _np(J.nlm_denoise(a, b, var, patch_r=2, window_r=3)), **TOL)


def test_cross_bilateral_matches_jax(buffers):
    a, _, var, feat, _ = buffers
    normal = feat[3:6] * 2 - 1
    args = (a, var, feat[:3], normal, feat[6:])
    np.testing.assert_allclose(
        _np(T.cross_bilateral_denoise(*_t(*args), window_r=3)),
        _np(J.cross_bilateral_denoise(*args, window_r=3)), **TOL)


def test_regression_filter_matches_jax(buffers):
    """NFOR's candidate: the moments, the ridge solves and the
    collaborative reconstruction."""
    a, b, var, feat, _ = buffers
    f = (feat - feat.mean((1, 2), keepdims=True)) / feat.std(
        (1, 2), keepdims=True)
    for k in (0.5, 1.0):
        np.testing.assert_allclose(
            _np(T._regression_filter(*_t(a, b, var, f), 2, 1, k)),
            _np(J._regression_filter(*map(jnp.asarray, (a, b, var, f)), 2, 1,
                                     k)), **TOL)


def test_nfor_matches_jax(buffers):
    a, b, var, feat, fvar = buffers
    args = (a, b, var, feat, 0.9 * feat, fvar)
    np.testing.assert_allclose(
        _np(T.nfor_denoise(*_t(*args), window_r=2, patch_r=1,
                           prefilter_r=1)),
        _np(J.nfor_denoise(*args, window_r=2, patch_r=1, prefilter_r=1)),
        **TOL)


def test_rpf_matches_jax():
    """Frame sizes that are not multiples of the cell (edge-padded), two
    iterations."""
    rng = np.random.RandomState(2)
    s, h, w = 4, 21, 30
    colors = rng.rand(s, 3, h, w).astype(np.float32)
    feats = rng.rand(s, 7, h, w).astype(np.float32)
    randoms = rng.rand(s, 5, h, w).astype(np.float32)
    got = T.rpf_denoise(*_t(colors, feats, randoms), radii=(3, 2))
    want = J.rpf_denoise(*map(jnp.asarray, (colors, feats, randoms)),
                         radii=(3, 2))
    assert got.shape == (3, h, w)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A synthetic 32x32 frame of sample records at 4 spp (RAW_MODE)."""
    root = str(tmp_path_factory.mktemp("records"))
    generate_dataset(root, n_scenes=1, ts=32, tiles_per_side=1, spp=4,
                     gt_spp=4, seed=21)
    d = TilesDataset(root, mode=TilesDataset.RAW_MODE, spp=4)
    return d[0]["features"], d.labels


@pytest.mark.parametrize("method", ["nlm", "cbf", "rpf", "nfor"])
def test_denoise_buffers_matches_jax(records, method):
    feats, labels = records
    got = T.denoise_buffers(feats, labels, method=method, device="cpu")
    want = J.denoise_buffers(feats, labels, method=method)
    assert got.shape == want.shape == (3, 32, 32) and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    moved = float((diff > 1e-5 + 1e-4 * np.abs(want)).mean())
    print("%s: max abs %.3g, values beyond 1e-5 + 1e-4 |jax|: %.3f%%"
          % (method, diff.max(), 100 * moved))
    assert moved <= 0.01 and diff.max() <= 5e-3


def test_denoise_buffers_falls_back_without_coordinates(records):
    """RPF without the sampler's coordinates takes the per-sample radiance
    deviation as its random parameters, as the JAX package does; an unknown
    method raises."""
    feats, labels = records
    keep = [i for i, n in enumerate(labels)
            if n not in ("dx", "dy", "lens_u", "lens_v", "t")]
    sub = feats[:, keep]
    names = [labels[i] for i in keep]
    got = T.denoise_buffers(sub, names, method="rpf", radii=(2,),
                            device="cpu")
    want = J.denoise_buffers(sub, names, method="rpf", radii=(2,))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="unknown baseline"):
        T.denoise_buffers(feats, labels, method="bm3d", device="cpu")


def test_denoise_buffers_takes_tensors_on_their_device(records):
    feats, labels = records
    got = T.denoise_buffers(torch.from_numpy(feats), labels, method="cbf",
                            window_r=2)
    want = T.denoise_buffers(feats, labels, method="cbf", window_r=2,
                             device="cpu")
    np.testing.assert_array_equal(got, want)


def test_denoise_buffers_puts_numpy_input_on_the_card(records):
    """A numpy array with no device goes to the card, as the JAX package's
    goes to its default accelerator: without CUDA that raises, as
    ``resolve_device("cuda")`` does."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    feats, labels = records
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.denoise_buffers(feats, labels, method="cbf", window_r=2)
