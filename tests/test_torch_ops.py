"""The port's splat/gather operators against ``sbmc_tpu.ops``.

Inputs are made from a seed with numpy and fed to both. Tolerances:

- scatter2gather is data movement: exact.
- Weighted sums: ``|port - jax| <= 1e-5 + 1e-5 * |jax|`` in float32 (the
  two sum up to 441 taps in other orders; sum_w reaches tens at k = 21).
- The progressive splat against the composed ``xla`` oracle: the same
  bound; against the Pallas kernel in interpret mode, the JAX package's
  own 2e-4 (tests/test_ops.py).
- The CUDA kernel's per-pixel function, built for the host with g++
  (``csrc/progressive_splat_host.cpp``), against the plain version:
  ``2e-4 + 2e-5 * |plain|``, the bound chip_smoke.py holds the kernel to.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import ops as jops
from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import _build, reference

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
# (shape, k): k = 21 only on tiny tiles.
CASES = [((9, 12), 3), ((11, 8), 5), ((6, 9), 21)]


def _jax(x, dtype):
    return jnp.asarray(x, jnp.float32).astype(dtype)


def _torch(x, dtype):
    return torch.tensor(np.asarray(x), dtype=torch.float32).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _state(rng, bs, c, h, w, init):
    if init:
        return (np.zeros((bs, c, h, w), np.float32),
                np.zeros((bs, 1, h, w), np.float32),
                np.full((bs, 1, h, w), -1e30, np.float32))
    return (rng.randn(bs, c, h, w).astype(np.float32),
            np.abs(rng.randn(bs, 1, h, w)).astype(np.float32),
            rng.randn(bs, 1, h, w).astype(np.float32))


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_scatter2gather_matches_jax(shape, k, tdt, jdt):
    rng = np.random.RandomState(k)
    wts = rng.randn(2, k * k, *shape).astype(np.float32)
    got = reference.scatter2gather_ref(_torch(wts, tdt))
    want = jops.scatter2gather(_jax(wts, jdt), backend="xla")
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))
    g, kmax = reference.scatter2gather_max_ref(_torch(wts, tdt))
    jg, jmax = jops.scatter2gather_max(_jax(wts, jdt), backend="xla")
    np.testing.assert_array_equal(_np(g), _np(jg))
    np.testing.assert_array_equal(_np(kmax), _np(jmax))


@pytest.mark.parametrize("k", [3, 5])
def test_scatter2gather_impulse(k):
    """A splat weight at tap (dy, dx) of pixel q lands at pixel
    q + (dy - o, dx - o), on the flipped tap (k-1-dy, k-1-dx)."""
    h, w, o = 9, 10, (k - 1) // 2
    for t in range(k * k):
        dy, dx = divmod(t, k)
        wts = torch.zeros(1, k * k, h, w)
        wts[0, t, 4, 5] = 1.0
        g = reference.scatter2gather_ref(wts)
        flip = (k - 1 - dy) * k + (k - 1 - dx)
        assert g[0, flip, 4 + dy - o, 5 + dx - o] == 1.0
        assert float(g.sum()) == 1.0


@pytest.mark.parametrize("shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_kernel_weighting_matches_jax(shape, k, tdt, jdt):
    rng = np.random.RandomState(10 + k)
    data = rng.randn(2, 3, *shape).astype(np.float32)
    wts = rng.randn(2, k * k, *shape).astype(np.float32)
    out, sw = reference.kernel_weighting_ref(_torch(data, torch.float32),
                                             _torch(wts, tdt))
    jout, _ = jops.kernel_weighting(jnp.asarray(data), _jax(wts, jdt),
                                    backend="xla")
    # The JAX oracle returns sum_w in the weights' dtype (bf16-rounded for
    # bf16 weights); the port accumulates and returns it in float32, so it
    # is held against the sum of the same weights widened to float32.
    _, jsw = jops.kernel_weighting(
        jnp.asarray(data), _jax(wts, jdt).astype(jnp.float32), backend="xla")
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(sw), _np(jsw), **TOL)
    maxes = rng.randn(2, *shape).astype(np.float32)
    r, w = reference.kernel_weighting_exp_ref(
        _torch(data, torch.float32), _torch(wts, tdt),
        _torch(maxes, torch.float32))
    jr, jw = jops.kernel_weighting_exp(jnp.asarray(data), _jax(wts, jdt),
                                       jnp.asarray(maxes), backend="xla")
    np.testing.assert_allclose(_np(r), _np(jr), **TOL)
    np.testing.assert_allclose(_np(w), _np(jw), **TOL)


def test_extract_patches_matches_jax():
    from sbmc_tpu.ops import reference as jref
    data = np.random.RandomState(0).randn(2, 3, 7, 6).astype(np.float32)
    np.testing.assert_array_equal(
        reference.extract_patches(torch.from_numpy(data), 5).numpy(),
        np.asarray(jref.extract_patches(jnp.asarray(data), 5)))


@pytest.mark.parametrize("shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("init", [True, False])
def test_progressive_splat_matches_jax(shape, k, tdt, jdt, init):
    rng = np.random.RandomState(20 + k)
    data = rng.randn(2, 3, *shape).astype(np.float32)
    wts = (3 * rng.randn(2, k * k, *shape)).astype(np.float32)
    st = _state(rng, 2, 3, *shape, init)
    got = ops.progressive_splat_update(
        _torch(data, torch.float32), _torch(wts, tdt),
        *(torch.from_numpy(s) for s in st))
    want = jops.progressive_splat_update(
        jnp.asarray(data), _jax(wts, jdt), *map(jnp.asarray, st),
        backend="xla")
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(r), **TOL)


@pytest.mark.parametrize("shape,k", [((10, 140), 3), ((33, 70), 5)])
def test_progressive_splat_matches_pallas_interpret(shape, k):
    """The plain version against the Pallas kernel itself (interpret mode),
    at the shapes the JAX package tests that kernel at."""
    rng = np.random.RandomState(0)
    data = rng.randn(2, 3, *shape).astype(np.float32)
    wts = rng.randn(2, k * k, *shape).astype(np.float32)
    st = _state(rng, 2, 3, *shape, False)
    got = ops.progressive_splat_update(
        torch.from_numpy(data), torch.from_numpy(wts),
        *(torch.from_numpy(s) for s in st))
    want = jops.progressive_splat_update(
        jnp.asarray(data), jnp.asarray(wts), *map(jnp.asarray, st),
        backend="pallas_interpret")
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(r), atol=2e-4, rtol=0)


@pytest.mark.parametrize("c,shape,k", [(3, (9, 12), 3), (2, (13, 7), 5),
                                       (3, (23, 25), 21), (2, (5, 4), 21)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [True, False])
def test_kernel_pixel_math_matches_plain(c, shape, k, tdt, init):
    """The CUDA kernel's per-pixel function (gather-from-splat index,
    image-bound handling, online softmax), run on the host."""
    lib = _build.load_host()
    rng = np.random.RandomState(30 + k + c)
    bs = 2
    data = torch.tensor(rng.randn(bs, c, *shape), dtype=torch.float32)
    logits = _torch(3 * rng.randn(bs, k * k, *shape), tdt)
    st = [torch.from_numpy(s) for s in _state(rng, bs, c, *shape, init)]
    want = reference.progressive_splat_update_ref(data, logits, *st)
    got = [torch.empty_like(s) for s in st]
    rc = lib.sbmc_progressive_splat_host(
        data.data_ptr(), logits.data_ptr(), int(tdt == torch.bfloat16),
        *(s.data_ptr() for s in st), *(g.data_ptr() for g in got),
        bs, c, *shape, k)
    assert rc == 0
    for g, r in zip(got, want):
        assert torch.all((g - r).abs() <= 2e-4 + 2e-5 * r.abs()), \
            float((g - r).abs().max())


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    args = [torch.tensor(rng.randn(1, 3, 6, 7), dtype=torch.float32),
            torch.tensor(rng.randn(1, 9, 6, 7), dtype=torch.float32)]
    args += [torch.from_numpy(s) for s in _state(rng, 1, 3, 6, 7, True)]
    ops.reset_launch_counts()
    got = ops.progressive_splat_update(*args)
    want = reference.progressive_splat_update_ref(*args)
    assert ops.launch_counts["progressive_splat"] == 0
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    # A tensor that requires grad is taken (the op is differentiable), still
    # on the plain versions and without a counted launch.
    out = ops.progressive_splat_update(args[0].requires_grad_(), *args[1:])
    out[0].sum().backward()
    assert args[0].grad.shape == args[0].shape
    assert set(ops.launch_counts.values()) == {0}


def test_kernel_wrapper_checks_inputs():
    """What the CUDA wrapper refuses, checked on CPU tensors."""
    def make(c=3, k=3, dtype=torch.float32):
        return [torch.zeros(2, c, 5, 6), torch.zeros(2, k * k, 5, 6,
                                                      dtype=dtype),
                torch.zeros(2, c, 5, 6), torch.zeros(2, 1, 5, 6),
                torch.zeros(2, 1, 5, 6)]
    assert ops._check(*make()) == (2, 3, 5, 6, 3)
    assert ops._check(*make(dtype=torch.bfloat16))[-1] == 3
    with pytest.raises(TypeError):
        ops._check(*make(dtype=torch.float16))
    bad = make()
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        ops._check(*bad)
    with pytest.raises(ValueError, match="channels"):
        ops._check(*make(c=5))
    bad = make()
    bad[1] = torch.zeros(2, 6, 5, 9).transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(*bad)
    bad = make()
    bad[3] = torch.zeros(2, 1, 5, 7)
    with pytest.raises(ValueError, match="sum_w"):
        ops._check(*bad)
    with pytest.raises(ValueError, match="square"):
        ops._check(*make()[:1], torch.zeros(2, 8, 5, 6), *make()[2:])
