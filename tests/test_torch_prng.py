"""The port's threefry keys and draws (``sbmc_tpu_torch.render.prng`` on the
host, ``ops.random_uniform`` / ``ops.random_bits`` and the host build of
their kernel's header ``csrc/threefry.cuh``) against ``jax.random``.

Keys, bits and uniforms are integer arithmetic and one exact float
conversion: they must be bit for bit equal. ``normal`` is
``sqrt(2) * erfinv(u)`` on bit-exact uniforms; XLA's ``erf_inv``
polynomial and ``torch.erfinv`` differ in the last bits, most in the tails
(up to ~90 ulps at |x| ~ 3.8 measured here), so it is held to a relative
error of 1e-5 and a 99.9th percentile of 16 ulps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import _build, reference
from sbmc_tpu_torch.render import pathtracer, prng

SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1, -1, -5)


def _jkey(key):
    return jnp.asarray(np.asarray(key, np.uint32))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(prng.PRNGKey(seed), want)


@pytest.mark.parametrize("num", (1, 2, 3, 8, 100))
def test_split(num):
    for seed in (0, 42, 2 ** 31 - 1):
        key = prng.PRNGKey(seed)
        want = np.asarray(jax.random.split(_jkey(key), num))
        np.testing.assert_array_equal(prng.split(key, num), want)


@pytest.mark.parametrize("data", (0, 1, 5, 123456, 2 ** 31 - 1))
def test_fold_in(data):
    for key in (prng.PRNGKey(3), prng.split(prng.PRNGKey(9), 4)[2]):
        want = np.asarray(jax.random.fold_in(_jkey(key), data))
        np.testing.assert_array_equal(prng.fold_in(key, data), want)


RANGES = ((0.0, 1.0), (prng.NORMAL_LO, 1.0), (-2.5, 3.0))


@pytest.mark.parametrize("shape", ((1,), (7,), (257,), (33, 3)))
@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_bit_exact(shape, lo, hi):
    """The host numpy version and the op's plain version (CPU tensors)."""
    keys = prng.split(prng.PRNGKey(11), 3)
    n = int(np.prod(shape))
    got = ops.random_uniform(torch.from_numpy(keys.view(np.int32)), n, lo,
                             hi).numpy()
    for i, key in enumerate(keys):
        want = np.asarray(jax.random.uniform(_jkey(key), shape, minval=lo,
                                             maxval=hi))
        np.testing.assert_array_equal(_bits(prng.uniform(key, shape, lo,
                                                         hi)), _bits(want))
        np.testing.assert_array_equal(_bits(got[i].reshape(shape)),
                                      _bits(want))


def test_random_bits_bit_exact():
    keys = prng.split(prng.PRNGKey(2), 4)
    got = ops.random_bits(torch.from_numpy(keys.view(np.int32)), 1000)
    for i, key in enumerate(keys):
        want = np.asarray(jax.random.bits(_jkey(key), (1000,), jnp.uint32))
        np.testing.assert_array_equal(prng.random_bits(key, 1000), want)
        np.testing.assert_array_equal(_bits(got[i].numpy()), want)


def test_normal_within_erfinv_ulps():
    worst_rel, ulps = 0.0, []
    for key in prng.split(prng.PRNGKey(5), 4):
        want = np.asarray(jax.random.normal(_jkey(key), (20000,)))
        u = ops.random_uniform(torch.from_numpy(key[None].view(np.int32)),
                               20000, prng.NORMAL_LO, 1.0)
        got = (torch.erfinv(u) * math.sqrt(2))[0].numpy()
        worst_rel = max(worst_rel, float(np.max(
            np.abs(got.astype(np.float64) - want) / np.abs(want))))
        ulps.append(np.abs(got.view(np.int32).astype(np.int64)
                           - want.view(np.int32).astype(np.int64)))
    assert worst_rel <= 1e-5
    assert np.percentile(np.concatenate(ulps), 99.9) <= 16


@pytest.mark.parametrize("n_keys,n", ((1, 1), (3, 255), (5, 257), (2, 1000)))
@pytest.mark.parametrize("lo,hi", RANGES[:2])
def test_host_build_equals_plain(n_keys, n, lo, hi):
    """The kernel's header on the host, bits and floats, bit for bit the
    plain version (n not a multiple of the kernel's 256-thread block)."""
    lib = _build.load_host()
    keys = np.stack([prng.fold_in(prng.PRNGKey(8), i)
                     for i in range(n_keys)])
    tkeys = torch.from_numpy(keys.view(np.int32))
    lo32, hi32 = np.float32(lo), np.float32(hi)
    for raw in (0, 1):
        out = np.empty((n_keys, n), np.uint32 if raw else np.float32)
        assert lib.sbmc_threefry_uniform_host(
            keys.ctypes.data, n_keys, n, float(lo32), float(hi32 - lo32),
            raw, out.ctypes.data) == 0
        want = reference.threefry_uniform_ref(tkeys, n, lo, hi, raw=bool(raw))
        np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))


def test_pass_keys_follow_render_pass():
    """The key schedule of one pass is render_pass's derivation in JAX."""
    key = prng.fold_in(prng.PRNGKey(4), 2)
    uni, nrm = pathtracer.pass_keys(key)
    keys = jax.random.split(_jkey(key), 8)
    want_u = [keys[i] for i in range(5)]
    want_n = []
    for d in range(pathtracer.MAX_DEPTH):
        k_nee, k_bsdf, k_lobe, k_fres = jax.random.split(
            jax.random.fold_in(keys[5], d), 4)
        want_n.append(jax.random.split(k_nee)[0])
        want_u.extend(jax.random.split(k_bsdf))
        want_u.extend(jax.random.split(k_lobe))
        want_u.append(k_fres)
    np.testing.assert_array_equal(uni, np.stack([np.asarray(k)
                                                 for k in want_u]))
    np.testing.assert_array_equal(nrm, np.stack([np.asarray(k)
                                                 for k in want_n]))


def test_wrapper_checks_keys():
    with pytest.raises(ValueError):
        ops._threefry_cuda(torch.zeros(3, dtype=torch.int64), 4, 0.0, 1.0,
                           False)
