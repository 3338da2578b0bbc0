"""The tiled kernel weighting of exp(logits - max) and its dispatch by shape.

The card's tiled ``kw_exp`` (``csrc/kernel_weighting.cu``) is the tiled
forward ``kw_fwd`` with the weight transform ``KwExp``: each item of V
pixels (2 where the logit rows and the maxes plane allow 2-pixel loads,
else 1) loads its V shifts once and forms each weight of a tap row as
``exp2(fma(L, log2 e, -m * log2 e))``; a block's threads form G groups of
tap rows joined in group order. Those pieces live in
``kernel_weighting.cuh`` as ``__host__ __device__`` functions, which the g++
host build (``_build.load_host``) assembles here exactly as the kernel does,
against ``reference.kernel_weighting_exp_ref``, the JAX package's
``kernel_weighting_exp(backend="xla")`` and its Pallas kernel
``_kw_exp_kernel`` in interpret mode: ``|got - want| <= 2e-4 + 2e-5 *
|want|``, the bound chip_smoke.py holds the kernel to (float32 sums over up
to 441 taps in another order; the exp2 form rounds the exponent at about
``(|L| + |m|) * 2**-24``). Inputs are made from a seed with numpy; the
shifts lie up to 2 below and up to 1 above each pixel's tap max, so some
weights exceed 1.
"""

import importlib.util
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

ATOL, RTOL = 2e-4, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]

#: (channels, (h, w), k, groups): KPCN's width 92 and the smoke's 124
#: (2-pixel items), odd widths 53 and 3 (1-pixel items), every group count
#: at k = 21, and k = 3 and 5 at group counts up to k.
CASES = [(3, (5, 92), 21, 1), (2, (4, 124), 21, 2), (3, (6, 53), 21, 4),
         (3, (5, 92), 21, 8), (2, (9, 3), 21, 8), (2, (9, 92), 5, 4),
         (3, (8, 124), 5, 2), (3, (7, 53), 3, 2), (2, (10, 3), 3, 1)]


def _inputs(rng, bs, c, h, w, k):
    """data, logits (3 x normal) and a shift in [tap max - 2, tap max + 1)."""
    data = rng.randn(bs, c, h, w).astype(np.float32)
    logits = (3 * rng.randn(bs, k * k, h, w)).astype(np.float32)
    maxes = (logits.max(1) + 3 * rng.rand(bs, h, w) - 2).astype(np.float32)
    return data, logits, maxes


def _exp_tiles(data, logits, maxes, v, groups):
    lib = _build.load_host()
    bs, c, h, w = data.shape
    out = torch.full_like(data, float("nan"))
    sum_w = torch.full((bs, h, w), float("nan"))
    rc = lib.sbmc_kernel_weighting_exp_tiles_host(
        data.data_ptr(), logits.data_ptr(),
        int(logits.dtype == torch.bfloat16), maxes.data_ptr(), out.data_ptr(),
        sum_w.data_ptr(), bs, c, h, w, reference.ksize_of(logits), v, groups)
    assert rc == 0
    return out, sum_w


def _close(got, want):
    want = torch.as_tensor(np.array(want, np.float32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.all((got - want).abs() <= ATOL + RTOL * want.abs()), \
        float((got - want).abs().max())


def _jax(data, logits, maxes, jdt, backend):
    return jops.kernel_weighting_exp(
        jnp.asarray(data), jnp.asarray(logits).astype(jdt),
        jnp.asarray(maxes), backend=backend)


@pytest.mark.parametrize("c,shape,k,groups", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_work_items_match_plain_and_jax(c, shape, k, groups, tdt, jdt):
    rng = np.random.RandomState(70 + k + c + shape[1])
    data, logits, maxes = _inputs(rng, 2, c, *shape, k)
    t = [torch.from_numpy(data), torch.from_numpy(logits).to(tdt),
         torch.from_numpy(maxes)]
    assert float((t[1].float().amax(1) - t[2]).max()) > 0  # weights above 1
    got = _exp_tiles(*t, ops.kw_pixels(shape[1], 2), groups)
    want = reference.kernel_weighting_exp_ref(*t)
    for g, r, j in zip(got, want, _jax(data, logits, maxes, jdt, "xla")):
        _close(g, r.numpy())
        _close(g, j)


@pytest.mark.parametrize("shape,k", [((6, 92), 5), ((7, 53), 3)])
def test_work_items_match_pallas_interpret(shape, k):
    """``_kw_exp_kernel`` itself, in interpret mode, on small tiles."""
    rng = np.random.RandomState(17 + k)
    data, logits, maxes = _inputs(rng, 1, 3, *shape, k)
    got = _exp_tiles(torch.from_numpy(data), torch.from_numpy(logits),
                     torch.from_numpy(maxes), ops.kw_pixels(shape[1], 2), 2)
    for g, j in zip(got, _jax(data, logits, maxes, jnp.float32,
                              "pallas_interpret")):
        _close(g, j)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_narrower_items_and_every_group_count_agree(tdt):
    """1- and 2-pixel items at one width, at every group count: the same
    sums to rounding."""
    rng = np.random.RandomState(19)
    data, logits, maxes = (torch.from_numpy(a)
                           for a in _inputs(rng, 2, 3, 6, 92, 21))
    logits = logits.to(tdt)
    want = _exp_tiles(data, logits, maxes, 2, 1)
    for v in (1, 2):
        for groups in (1, 2, 4, 8):
            for g, r in zip(_exp_tiles(data, logits, maxes, v, groups),
                            want):
                _close(g, r.numpy())


def _exp_generic(data, logits, maxes):
    lib = _build.load_host()
    bs, c, h, w = data.shape
    out = torch.full_like(data, float("nan"))
    sum_w = torch.full((bs, h, w), float("nan"))
    assert lib.sbmc_kernel_weighting_exp_host(
        data.data_ptr(), logits.data_ptr(),
        int(logits.dtype == torch.bfloat16), maxes.data_ptr(), out.data_ptr(),
        sum_w.data_ptr(), bs, c, h, w, reference.ksize_of(logits)) == 0
    return out, sum_w


def test_extreme_logits_weigh_as_the_plain_version():
    """A logit of -inf weighs 0; one far above its shift weighs inf (its
    taps' outputs inf, or NaN where it meets a zero datum, the zero padding
    included), exactly where the plain version's ``exp`` puts them: in the
    tiled kernel's work items and in the generic kernel's pixels."""
    rng = np.random.RandomState(23)
    data, logits, maxes = (torch.from_numpy(a)
                           for a in _inputs(rng, 1, 3, 9, 12, 5))
    logits[0, :, 2, 3] = -float("inf")         # every tap of one pixel
    logits[0, 7, 4, 5] = -float("inf")         # one tap of another
    logits[0, 12, 6, 8] = maxes[0, 6, 8] + 200  # exp overflows
    logits[0, 0, 0, 0] = maxes[0, 0, 0] + 300   # a tap in the padding
    for tdt in (torch.float32, torch.bfloat16):
        lg = logits.to(tdt)
        want = reference.kernel_weighting_exp_ref(data, lg, maxes)
        runs = [_exp_tiles(data, lg, maxes, v, 2) for v in (1, 2)]
        for got in runs + [_exp_generic(data, lg, maxes)]:
            for g, r in zip(got, want):
                assert torch.equal(torch.isnan(g), torch.isnan(r))
                assert torch.equal(torch.isinf(g), torch.isinf(r))
                assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
                fin = torch.isfinite(r)
                _close(g[fin], r[fin].numpy())
        assert float(want[1][0, 2, 3]) == 0.0
        assert torch.all(want[0][0, :, 2, 3] == 0)
        assert torch.isinf(want[1][0, 6, 8]) and torch.isinf(want[1][0, 0, 0])
        assert torch.isnan(want[0][0, :, 0, 0]).all()


def test_host_build_refuses_what_the_tiled_kernel_does_not_take():
    lib = _build.load_host()
    z, one = torch.zeros(1, 3, 4, 7), torch.zeros(1, 4, 7)

    def run(k, v, groups, c=3):
        logits = torch.zeros(1, k * k, 4, 7)
        return lib.sbmc_kernel_weighting_exp_tiles_host(
            z.data_ptr(), logits.data_ptr(), 0, one.data_ptr(), z.data_ptr(),
            one.data_ptr(), 1, c, 4, 7, k, v, groups)

    assert run(5, 1, 4) == 0
    assert run(7, 1, 1) == 1   # k outside the template set
    assert run(5, 2, 1) == 1   # 2-pixel items at an odd width
    assert run(5, 1, 3) == 1   # 3 groups
    assert run(3, 1, 4) == 1   # more groups than tap rows
    assert run(5, 4, 1) == 1   # the forward's items are at most 2 pixels
    assert run(5, 1, 1, c=4) == 1  # channels outside {2, 3}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_step_shape_takes_the_tiled_kernel():
    """Every shape at which chip_smoke.py composes the splat step takes the
    tiled kernel, with 2-pixel items where the width is even; k = 7 takes
    the generic one."""
    for bs, c, h, w, k, dtype in _chip_smoke().STEP_SHAPES:
        assert ops.kw_route(k) == "tiled"
        assert ops.kw_pixels(w, 2) == (2 if w % 2 == 0 else 1)
        assert ops.kw_exp_groups(bs, h, w, k, ops.kw_pixels(w, 2), 132) in \
            [g for g in (1, 2, 4, 8) if g <= k]
    assert ops.kw_route(7) == "generic"


def test_kw_exp_groups_at_the_timed_shapes():
    """A 1080x2048 tile in one group (4320 eight-row tiles); the training
    batch of 128x128 in two (256 four-row tiles, one per SM at least) in
    either logit type, where kw_groups gives bfloat16 weights four; a
    misaligned base's 1-pixel items double the tiles."""
    assert ops.kw_exp_groups(1, 1080, 2048, 21, 2, 132) == 1
    assert ops.kw_exp_groups(4, 128, 128, 21, 2, 132) == 2
    assert ops.kw_groups(4, 128, 128, 21, 2, 2, 132) == 4
    assert ops.kw_exp_groups(4, 128, 128, 21, 1, 132) == 1
    assert ops.kw_exp_groups(1, 5, 7, 3, 1, 132) == 2  # at most k


def test_cpu_tensors_launch_nothing():
    rng = np.random.RandomState(29)
    t = [torch.from_numpy(a) for a in _inputs(rng, 1, 3, 5, 6, 3)]
    ops.reset_launch_counts()
    got = ops.kernel_weighting_exp(*t)
    want = reference.kernel_weighting_exp_ref(*t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts["kernel_weighting_exp"] == 0
    assert ops.launch_counts["kernel_weighting_exp_generic"] == 0
