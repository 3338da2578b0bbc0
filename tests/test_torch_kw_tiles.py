"""The tiled kernel-weighting kernels' arithmetic and their dispatch by shape.

The card's tiled kernels (``kw_fwd`` and ``kw_dw`` in
``csrc/kernel_weighting.cu``) work on items of V pixels (the forward's 2
where the weight rows allow 2-pixel loads, the gradient's 4 or 2 where its
rows allow such stores, else 1) and one tap row at a time; a block's
threads form G groups of tap rows, and the forward joins the groups'
partial sums in group order. Those pieces live in ``kernel_weighting.cuh``
as ``__host__ __device__`` functions, which the g++ host build
(``_build.load_host``) assembles here exactly as the kernels do:

- the forward against ``reference.kernel_weighting_ref``, the JAX package's
  ``kernel_weighting(backend="xla")`` and its Pallas kernel
  ``_kw_fwd_kernel`` in interpret mode: ``|got - want| <= 2e-4 + 2e-5 *
  |want|``, the bound chip_smoke.py holds the kernel to (float32 sums over
  up to 441 taps in another order);
- the weight gradient against ``reference.kernel_weighting_dw_ref`` and the
  JAX package's gradient (``xla`` and ``_kw_dw_kernel`` in interpret mode):
  the same bound in float32; written for bfloat16 weights it is the float32
  value rounded once to nearest even (bit for bit), which lies within one
  bfloat16 step of the plain float32 gradient (``2e-4 + 2**-7 * |want|``).

JAX returns ``sum_w`` in bfloat16 for bfloat16 weights (a divergence
recorded in ROADMAP.md), so the port's float32 ``sum_w`` is held against
JAX's sum of the widened weights. Inputs are made from a seed with numpy.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import ops as jops
from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import _build, reference
from sbmc_tpu_torch.parallel.tiles import split_tiles

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ATOL, RTOL, BF16_RTOL = 2e-4, 2e-5, 2.0 ** -7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]

#: (channels, (h, w), k, groups): KPCN's training width 92 and the smoke's
#: denoise width 124 (2-pixel items in the forward, 4-pixel ones in the
#: gradient), a width of 2 mod 4 (2-pixel items in both), odd widths
#: (1-pixel items), every group count each kernel size allows.
CASES = [(3, (5, 92), 21, 1), (3, (5, 92), 21, 8), (2, (4, 124), 21, 4),
         (3, (6, 53), 21, 2), (2, (9, 92), 5, 4), (3, (8, 124), 5, 2),
         (3, (7, 53), 3, 2), (2, (10, 31), 3, 1), (3, (6, 30), 21, 4)]


def _inputs(rng, bs, c, h, w, k):
    return (rng.randn(bs, c, h, w).astype(np.float32),
            rng.randn(bs, k * k, h, w).astype(np.float32),
            rng.randn(bs, c, h, w).astype(np.float32),
            rng.randn(bs, h, w).astype(np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.float()
    want = torch.tensor(np.array(want, np.float32))
    assert got.shape == want.shape
    assert torch.all((got - want).abs() <= atol + rtol * want.abs()), \
        float((got - want).abs().max())


def _fwd_tiles(data, weights, v, groups):
    lib = _build.load_host()
    bs, c, h, w = data.shape
    out = torch.full_like(data, float("nan"))
    sum_w = torch.full((bs, h, w), float("nan"))
    rc = lib.sbmc_kernel_weighting_tiles_host(
        data.data_ptr(), weights.data_ptr(),
        int(weights.dtype == torch.bfloat16), out.data_ptr(),
        sum_w.data_ptr(), bs, c, h, w, reference.ksize_of(weights), v, groups)
    assert rc == 0
    return out, sum_w


def _dw_tiles(data, d_out, d_sw, k, dtype, v, groups):
    lib = _build.load_host()
    bs, c, h, w = data.shape
    d_w = torch.full((bs, k * k, h, w), float("nan")).to(dtype)
    rc = lib.sbmc_kernel_weighting_dw_tiles_host(
        data.data_ptr(), d_out.data_ptr(), d_sw.data_ptr(), d_w.data_ptr(),
        int(dtype == torch.bfloat16), bs, c, h, w, k, v, groups)
    assert rc == 0
    return d_w


def _jax_fwd(data, wts, jdt, backend):
    jw = jnp.asarray(wts).astype(jdt)
    out, _ = jops.kernel_weighting(jnp.asarray(data), jw, backend=backend)
    _, sw = jops.kernel_weighting(jnp.asarray(data), jw.astype(jnp.float32),
                                  backend=backend)
    return out, sw


def _jax_dw(data, wts, ct_out, ct_sw, backend):
    """The JAX package's float32 gradient to float32 weights."""
    def scalar(w):
        out, sw = jops.kernel_weighting(jnp.asarray(data), w,
                                        backend=backend)
        return jnp.sum(out * ct_out) + jnp.sum(sw * ct_sw)
    return jax.grad(scalar)(jnp.asarray(wts))


@pytest.mark.parametrize("c,shape,k,groups", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_forward_work_items_match_plain_and_jax(c, shape, k, groups, tdt,
                                                jdt):
    rng = np.random.RandomState(90 + k + c + shape[1])
    data, wts, _, _ = _inputs(rng, 2, c, *shape, k)
    t_data = torch.from_numpy(data)
    t_wts = torch.from_numpy(wts).to(tdt)
    got = _fwd_tiles(t_data, t_wts, ops.kw_pixels(shape[1], 2), groups)
    want = reference.kernel_weighting_ref(t_data, t_wts)
    for g, r, j in zip(got, want, _jax_fwd(data, wts, jdt, "xla")):
        _close(g, r.numpy())
        _close(g, j)


@pytest.mark.parametrize("c,shape,k,groups", CASES)
def test_weight_gradient_work_items_match_plain_and_jax(c, shape, k, groups):
    rng = np.random.RandomState(95 + k + c + shape[1])
    data, wts, ct_out, ct_sw = _inputs(rng, 2, c, *shape, k)
    args = (torch.from_numpy(data), torch.from_numpy(ct_out),
            torch.from_numpy(ct_sw), k)
    v = ops.kw_pixels(shape[1], 4)
    got = _dw_tiles(*args, torch.float32, v, groups)
    want = reference.kernel_weighting_dw_ref(*args)
    _close(got, want.numpy())
    _close(got, _jax_dw(data, wts, ct_out, ct_sw, "xla"))
    # Written for bfloat16 weights: the float32 value rounded once.
    got_bf16 = _dw_tiles(*args, torch.bfloat16, v, groups)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))
    _close(got_bf16, want.numpy(), rtol=BF16_RTOL)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_narrower_items_at_the_same_width(tdt):
    """Where the tap planes' base is not aligned to the widest item the
    kernels take narrower ones at the same width: the forward's sums are
    the same to rounding, the gradient is the same bit for bit."""
    rng = np.random.RandomState(11)
    data, wts, ct_out, ct_sw = (torch.from_numpy(a)
                                for a in _inputs(rng, 2, 3, 6, 92, 21))
    wts = wts.to(tdt)
    for g, r in zip(_fwd_tiles(data, wts, 1, 8),
                    _fwd_tiles(data, wts, 2, 8)):
        _close(g, r.numpy())
    want = _dw_tiles(data, ct_out, ct_sw, 21, tdt, 4, 4)
    for v in (1, 2):
        assert torch.equal(_dw_tiles(data, ct_out, ct_sw, 21, tdt, v, 4),
                           want)


@pytest.mark.parametrize("shape,k", [((6, 92), 5), ((7, 53), 3)])
def test_work_items_match_pallas_interpret(shape, k):
    """The Pallas kernels themselves, in interpret mode:
    ``_kw_fwd_kernel`` and, through ``jax.grad``, ``_kw_dw_kernel``."""
    rng = np.random.RandomState(13 + k)
    data, wts, ct_out, ct_sw = _inputs(rng, 1, 3, *shape, k)
    got = _fwd_tiles(torch.from_numpy(data), torch.from_numpy(wts),
                     ops.kw_pixels(shape[1], 2), 2)
    for g, j in zip(got, _jax_fwd(data, wts, jnp.float32,
                                  "pallas_interpret")):
        _close(g, j)
    got = _dw_tiles(torch.from_numpy(data), torch.from_numpy(ct_out),
                    torch.from_numpy(ct_sw), k, torch.float32,
                    ops.kw_pixels(shape[1], 4), 2)
    _close(got, _jax_dw(data, wts, ct_out, ct_sw, "pallas_interpret"))


def test_infinite_weights_meet_the_zero_padding_as_in_the_plain_version():
    """An infinite weight on a tap outside the image gives NaN (inf * 0),
    and inside it gives +-inf, in the tiled kernel's work items and in the
    generic kernel's pixels, where the zero-padded plain version does."""
    lib = _build.load_host()
    rng = np.random.RandomState(17)
    data, wts = (torch.from_numpy(a) for a in _inputs(rng, 1, 3, 9, 12, 5)[:2])
    wts[0, 0, 0, 0] = float("inf")    # tap (0, 0) of pixel (0, 0): padding
    wts[0, 12, 6, 8] = float("inf")   # the centre tap of pixel (6, 8)
    want = reference.kernel_weighting_ref(data, wts)
    assert torch.isnan(want[0][0, :, 0, 0]).all()
    out = torch.full_like(data, float("nan"))
    sum_w = torch.full((1, 9, 12), float("nan"))
    assert lib.sbmc_kernel_weighting_host(
        data.data_ptr(), wts.data_ptr(), 0, out.data_ptr(), sum_w.data_ptr(),
        1, 3, 9, 12, 5) == 0
    for got in (_fwd_tiles(data, wts, 1, 2), _fwd_tiles(data, wts, 2, 4),
                (out, sum_w)):
        for g, r in zip(got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(r))
            assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
            fin = torch.isfinite(r)
            _close(g[fin], r[fin].numpy())


def test_host_builds_refuse_what_the_tiled_kernels_do_not_take():
    lib = _build.load_host()
    z, one = torch.zeros(1, 3, 4, 7), torch.zeros(1, 4, 7)

    def fwd(k, v, groups):
        wts = torch.zeros(1, k * k, 4, 7)
        return lib.sbmc_kernel_weighting_tiles_host(
            z.data_ptr(), wts.data_ptr(), 0, z.data_ptr(), one.data_ptr(), 1,
            3, 4, 7, k, v, groups)

    def dw(k, v, groups):
        d_w = torch.zeros(1, k * k, 4, 7)
        return lib.sbmc_kernel_weighting_dw_tiles_host(
            z.data_ptr(), z.data_ptr(), one.data_ptr(), d_w.data_ptr(), 0, 1,
            3, 4, 7, k, v, groups)

    for fn in (fwd, dw):
        assert fn(5, 1, 4) == 0
        assert fn(7, 1, 1) == 1   # k outside the template set
        assert fn(5, 2, 1) == 1   # 2-pixel items at an odd width
        assert fn(5, 1, 3) == 1   # 3 groups
        assert fn(3, 1, 4) == 1   # more groups than tap rows
        assert fn(5, 3, 1) == 1   # 3-pixel items
        assert fn(5, 4, 1) == 1   # 4-pixel items at an odd width


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kpcn_tile_sizes():
    """(h, w) kernel weighting sees on the default denoise CLI's ragged
    tiles (512, pad 128) of 1080x1920 and 1080x2048 frames: KPCN's valid
    convs take 36 pixels off each side length."""
    sizes = set()
    for hw in ((1080, 1920), (1080, 2048)):
        tiles = split_tiles({"features": torch.zeros(1, 1, 1, *hw)},
                            max_sz=512, pad=128)
        sizes |= {tuple(s - 36 for s in t[0]["features"].shape[-2:])
                  for t in tiles}
    return sorted(sizes)


def test_every_path_shape_takes_the_tiled_kernels():
    shapes = [s[:4] for s in _chip_smoke().KW_PATH_SHAPES]
    sizes = _kpcn_tile_sizes()
    assert sizes == [(276, 348), (276, 476), (476, 348), (476, 476)]
    shapes += [(1, 3) + s for s in sizes] + [(1, 3, 1080, 2048)]
    for bs, c, h, w in shapes:
        assert ops.kw_route(21) == "tiled"
        # Wide items at every width but the gradient phase's odd 53.
        assert ops.kw_pixels(w, 2) == (1 if w == 53 else 2), w
        assert ops.kw_pixels(w, 4) == (1 if w == 53 else 4), w
        for itemsize in (2, 4):
            assert ops.kw_groups(bs, h, w, 21, ops.kw_pixels(w, 2), itemsize,
                                 132) in (1, 2, 4, 8)


@pytest.mark.parametrize("k,route", [(3, "tiled"), (5, "tiled"),
                                     (21, "tiled"), (1, "generic"),
                                     (7, "generic"), (9, "generic")])
def test_kw_route(k, route):
    assert ops.kw_route(k) == route


def test_kw_pixels_and_groups():
    assert ops.kw_pixels(92, 2) == 2 and ops.kw_pixels(92, 4) == 4
    assert ops.kw_pixels(30, 4) == 2 and ops.kw_pixels(53, 4) == 1
    # A base one element past an aligned one, and one two elements past.
    assert ops.kw_pixels(2048, 4, offset=1) == 1
    assert ops.kw_pixels(2048, 4, offset=6) == 2
    # The forward: KPCN's training batch of 92x92 (2-pixel items) in 2
    # groups in float32 (184 four-row tiles, over one per SM) and in 4 in
    # bfloat16 (368 two-row tiles, over two per SM); a 1080x2048 tile in
    # one group (4320 eight-row tiles); the smoke's 124x124 KPCN tile in 8.
    assert ops.kw_groups(4, 92, 92, 21, 2, 4, 132) == 2
    assert ops.kw_groups(4, 92, 92, 21, 2, 2, 132) == 4
    assert ops.kw_groups(1, 1080, 2048, 21, 2, 4, 132) == 1
    assert ops.kw_groups(1, 1080, 2048, 21, 2, 2, 132) == 1
    assert ops.kw_groups(1, 124, 124, 21, 2, 4, 132) == 8
    # Never more groups than tap rows.
    assert ops.kw_groups(1, 5, 7, 3, 1, 4, 132) == 2
    # The gradient: 8 groups, at most k.
    assert [ops.kw_dw_groups(k) for k in (3, 5, 21)] == [2, 4, 8]
