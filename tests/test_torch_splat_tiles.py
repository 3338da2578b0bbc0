"""The tiled splat kernels' arithmetic and their dispatch by shape.

The card's tiled forward (``psf_tma`` in ``csrc/progressive_splat.cu``)
runs the online softmax one row of k taps at a time and merges partial
states; its vector logits gradient (``psb_dlogits_vec`` in
``csrc/progressive_splat_bwd.cu``) works on 16 bytes of pixels and one tap
row at a time. Both pieces live in the headers as ``__host__ __device__``
functions, which the g++ host build (``_build.load_host``) runs here:

- the forward's box reads, row update and state merge, assembled tile by
  tile at both tile heights as the kernel assembles them (its TMA boxes
  emulated: clamped, 16-byte aligned starts, zeros past the right and bottom
  edges; edge tiles and interior ones, ragged last tiles), against
  ``reference.progressive_splat_update_ref`` and the JAX package's
  ``progressive_splat_update(backend="xla")``:
  ``|got - want| <= 2e-4 + 2e-5 * |want|``, the bound chip_smoke.py holds the
  kernel to (float32 sums over up to 441 taps in another order, exp taken as
  exp2 of a scaled argument);
- the gradient's work items against ``progressive_splat_dlogits_ref``:
  ``3e-4 + 2e-5 * |want|``, and ``2**-7`` relative for a bfloat16 gradient,
  which may sit on the neighbouring bfloat16 value.

Inputs are made from a seed with numpy.
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
BWD_ATOL, BWD_RTOL, BF16_RTOL = 3e-4, 2e-5, 2.0 ** -7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(rng, bs, c, h, w, init):
    if init:
        return (np.zeros((bs, c, h, w), np.float32),
                np.zeros((bs, 1, h, w), np.float32),
                np.full((bs, 1, h, w), -1e30, np.float32))
    return (rng.randn(bs, c, h, w).astype(np.float32),
            np.abs(rng.randn(bs, 1, h, w)).astype(np.float32),
            rng.randn(bs, 1, h, w).astype(np.float32))


def _close(got, want, atol, rtol):
    got, want = got.float(), torch.tensor(np.array(want, np.float32))
    assert got.shape == want.shape
    assert torch.all((got - want).abs() <= atol + rtol * want.abs()), \
        float((got - want).abs().max())


#: (channels, (h, w), k) of the tiled forward's host build: rows of whole
#: 16-byte vectors in both types; interior tiles at both tile heights
#: (19x72 at k = 3, 37x72 and 27x48 at k = 21), an image smaller than one
#: tile, ragged last tiles (21x40, 27x48).
ROWS_CASES = [(3, (19, 72), 3), (2, (13, 8), 5), (3, (21, 40), 5),
              (3, (37, 72), 21), (2, (27, 48), 21)]


@pytest.mark.parametrize("c,shape,k", ROWS_CASES)
@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("tile_h", [8, 16])
def test_row_update_and_merge_match_plain_and_jax(c, shape, k, tdt, jdt,
                                                  init, tile_h):
    lib = _build.load_host()
    rng = np.random.RandomState(40 + k + c)
    bs = 2
    data = rng.randn(bs, c, *shape).astype(np.float32)
    wts = (3 * rng.randn(bs, k * k, *shape)).astype(np.float32)
    st = _state(rng, bs, c, *shape, init)
    t_data = torch.from_numpy(data)
    t_logits = torch.from_numpy(wts).to(tdt)
    t_state = [torch.from_numpy(s) for s in st]
    got = [torch.empty_like(s) for s in t_state]
    rc = lib.sbmc_progressive_splat_rows_host(
        t_data.data_ptr(), t_logits.data_ptr(), int(tdt == torch.bfloat16),
        *(s.data_ptr() for s in t_state), *(g.data_ptr() for g in got),
        bs, c, *shape, k, tile_h)
    assert rc == 0
    want = reference.progressive_splat_update_ref(t_data, t_logits, *t_state)
    jax_want = jops.progressive_splat_update(
        jnp.asarray(data), jnp.asarray(wts).astype(jdt), *map(jnp.asarray, st),
        backend="xla")
    for g, r, j in zip(got, want, jax_want):
        _close(g, r.numpy(), ATOL, RTOL)
        _close(g, jnp.asarray(j, jnp.float32), ATOL, RTOL)


@pytest.mark.parametrize("c,shape,k", [(3, (9, 16), 3), (2, (13, 8), 5),
                                       (3, (11, 16), 21), (2, (5, 8), 21)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_dlogits_work_items_match_plain(c, shape, k, tdt):
    lib = _build.load_host()
    rng = np.random.RandomState(50 + k + c)
    bs = 2
    data = torch.tensor(rng.randn(bs, c, *shape), dtype=torch.float32)
    logits = torch.tensor(3 * rng.randn(bs, k * k, *shape),
                          dtype=torch.float32).to(tdt)
    st = [torch.from_numpy(s) for s in _state(rng, bs, c, *shape, False)]
    new_max = reference.progressive_splat_update_ref(data, logits, *st)[2]
    d_r = torch.tensor(rng.randn(bs, c, *shape), dtype=torch.float32)
    d_w = torch.tensor(rng.randn(bs, 1, *shape), dtype=torch.float32)
    got = torch.empty_like(logits)
    rc = lib.sbmc_progressive_splat_dlogits_rows_host(
        data.data_ptr(), logits.data_ptr(), int(tdt == torch.bfloat16),
        new_max.data_ptr(), d_r.data_ptr(), d_w.data_ptr(), got.data_ptr(),
        bs, c, *shape, k)
    assert rc == 0
    want = reference.progressive_splat_dlogits_ref(data, logits, new_max,
                                                   d_r, d_w)
    assert want.dtype == tdt
    rtol = BF16_RTOL if tdt == torch.bfloat16 else BWD_RTOL
    _close(got, want.float().numpy(), BWD_ATOL, rtol)
    # Taps whose target pixel lies outside the image get exactly 0.
    o = (k - 1) // 2
    for t in (0, k * k - 1):
        dy, dx = divmod(t, k)
        ys = [y for y in range(shape[0]) if not 0 <= y + dy - o < shape[0]]
        xs = [x for x in range(shape[1]) if not 0 <= x + dx - o < shape[1]]
        assert not got[:, t, ys].any() and not got[:, t, :, xs].any()


def test_host_builds_refuse_what_the_tiled_kernels_do_not_take():
    lib = _build.load_host()
    z = torch.zeros(1, 3, 4, 8)
    zl = torch.zeros(1, 49, 4, 8)
    one = torch.zeros(1, 1, 4, 8)
    # k = 7 is outside the template set; so are a tile height of 12 and a
    # width of 6 bf16 logits.
    def rows(k, tile_h):
        return lib.sbmc_progressive_splat_rows_host(
            z.data_ptr(), zl.data_ptr(), 0, z.data_ptr(), one.data_ptr(),
            one.data_ptr(), z.data_ptr(), one.data_ptr(), one.data_ptr(),
            1, 3, 4, 8, k, tile_h)
    assert rows(7, 8) == 1 and rows(3, 12) == 1
    assert rows(3, 8) == 0 and rows(3, 16) == 0
    zb = torch.zeros(1, 9, 4, 6, dtype=torch.bfloat16)
    z6, one6 = torch.zeros(1, 3, 4, 6), torch.zeros(1, 1, 4, 6)
    assert lib.sbmc_progressive_splat_dlogits_rows_host(
        z6.data_ptr(), zb.data_ptr(), 1, one6.data_ptr(), z6.data_ptr(),
        one6.data_ptr(), zb.data_ptr(), 1, 3, 4, 6, 3) == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_path_shape_takes_the_tiled_kernels():
    smoke = _chip_smoke()
    shapes = [s[:4] + (s[4],) for s in smoke.PATH_SHAPES]
    # The default denoise CLI's tiles (split_tiles at 512, pad 128) and one
    # full 1080x2048 tile.
    shapes += [(1, 3, 512, 512, torch.bfloat16),
               (1, 3, 312, 512, torch.bfloat16),
               (1, 3, 1080, 2048, torch.bfloat16)]
    for bs, c, h, w, dtype in shapes:
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert ops.splat_route(w, 21, itemsize) == "tiled", (h, w, dtype)


@pytest.mark.parametrize("w,k,dtype,aligned,route", [
    (53, 3, torch.float32, True, "generic"),     # 212-byte rows
    (53, 21, torch.bfloat16, True, "generic"),
    (3, 5, torch.float32, True, "generic"),
    (7, 21, torch.bfloat16, True, "generic"),
    (12, 3, torch.bfloat16, True, "generic"),    # 24-byte rows
    (12, 3, torch.float32, True, "tiled"),       # 48-byte rows
    (8, 21, torch.bfloat16, True, "tiled"),
    (64, 7, torch.float32, True, "generic"),     # k outside the set
    (2048, 21, torch.bfloat16, False, "generic"),  # unaligned base
    (2048, 21, torch.float32, True, "tiled"),
])
def test_shape_dispatch(w, k, dtype, aligned, route):
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert ops.splat_route(w, k, itemsize, aligned) == route


def test_smoke_odd_shapes_take_the_generic_kernels():
    """chip_smoke.py's odd shapes (37x53, 130x3, 5x7) keep the generic
    kernels checked on the card."""
    for w in (53, 3, 7):
        for itemsize in (2, 4):
            assert ops.splat_route(w, 21, itemsize) == "generic"


def test_tile_choices():
    # 16-row tiles where 8-row ones would need as many waves of two blocks
    # per SM twice over (the default CLI's 512x512 tile: 2 waves against
    # 4), 8-row tiles elsewhere (1080x2048: 33 waves against 17; the 312-row
    # tiles of a 1080p frame: 3 against 2; the training batch: 1 against 1).
    assert ops.splat_tile_rows(1, 512, 512, 132) == 16
    assert ops.splat_tile_rows(1, 1080, 2048, 132) == 8
    assert ops.splat_tile_rows(1, 312, 512, 132) == 8
    assert ops.splat_tile_rows(4, 128, 128, 132) == 8
    # The vector gradient: one block per 8x64 tile at 1080x2048 and 512x512,
    # rows split in 2 on a 312x512 tile and in 4 at the training batch (128
    # tiles) for three blocks per SM, at most k.
    assert ops.dlogits_row_blocks(1, 1080, 2048, 21, 132) == 1
    assert ops.dlogits_row_blocks(1, 512, 512, 21, 132) == 1
    assert ops.dlogits_row_blocks(1, 312, 512, 21, 132) == 2
    assert ops.dlogits_row_blocks(4, 128, 128, 21, 132) == 4
    assert ops.dlogits_row_blocks(1, 48, 48, 21, 132) == 21
    assert ops.dlogits_row_blocks(1, 8, 64, 3, 132) == 3
