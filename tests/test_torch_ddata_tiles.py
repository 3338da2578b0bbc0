"""The vector d_data kernel's arithmetic and its dispatch by shape.

The card's vector kernel of the splat step's gradient to the data
(``psb_ddata_vec`` in ``csrc/progressive_splat_bwd.cu``) works on items of
16 bytes of logits (4 float32 or 8 bfloat16 pixels) and one tap row at a
time; the G groups of tap rows in a block each sum their rows, and the sums
are joined in group order. Those pieces live in ``progressive_splat_bwd.cuh``
as ``__host__ __device__`` functions, which the g++ host build
(``_build.load_host``) assembles here exactly as the kernel does, at every
group count, against
``reference.progressive_splat_ddata_ref``, the d_data of the JAX package's
``progressive_splat_update(backend="xla")`` gradient and of its Pallas
backward (``progressive_splat_bwd_pallas``) in interpret mode:
``|got - want| <= 3e-4 + 2e-5 * |want|``, the bound chip_smoke.py holds the
kernel to (float32 sums over up to 441 taps in another order, exp taken as
exp2 of a scaled argument). Inputs are made from a seed with numpy; the
running max is the forward's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import ops as jops
from sbmc_tpu.ops import pallas_kernels
from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import _build, reference

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ATOL, RTOL = 3e-4, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]

#: (channels, (h, w), k, groups): rows of whole 16-byte vectors in both
#: types (widths 8, 16, 40 and 64), images smaller than the halo (5x8, 6x16
#: at k = 21), and every group count the kernel takes at each k (1, 2, 4,
#: 8, at most k).
CASES = [(3, (9, 16), 3, 1), (3, (9, 16), 3, 2), (2, (13, 8), 5, 1),
         (2, (13, 8), 5, 4), (3, (7, 40), 5, 2), (3, (11, 16), 21, 1),
         (2, (5, 8), 21, 8), (3, (6, 16), 21, 2), (2, (9, 64), 21, 4),
         (3, (4, 40), 21, 8)]


def _inputs(rng, bs, c, h, w, k):
    data = rng.randn(bs, c, h, w).astype(np.float32)
    logits = (3 * rng.randn(bs, k * k, h, w)).astype(np.float32)
    state = (rng.randn(bs, c, h, w).astype(np.float32),
             np.abs(rng.randn(bs, 1, h, w)).astype(np.float32),
             rng.randn(bs, 1, h, w).astype(np.float32))
    cts = (rng.randn(bs, c, h, w).astype(np.float32),
           rng.randn(bs, 1, h, w).astype(np.float32))
    return data, logits, state, cts


def _tiles(logits, new_max, d_r, groups):
    lib = _build.load_host()
    bs, c, h, w = d_r.shape
    got = torch.full_like(d_r, float("nan"))
    rc = lib.sbmc_progressive_splat_ddata_tiles_host(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        new_max.data_ptr(), d_r.data_ptr(), got.data_ptr(), bs, c, h, w,
        reference.ksize_of(logits), groups)
    assert rc == 0
    return got


def _close(got, want):
    want = torch.tensor(np.array(want, np.float32))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.all((got - want).abs() <= ATOL + RTOL * want.abs()), \
        float((got - want).abs().max())


def _case(c, shape, k, tdt, seed):
    rng = np.random.RandomState(seed)
    data, logits, state, cts = _inputs(rng, 2, c, *shape, k)
    t_logits = torch.from_numpy(logits).to(tdt)
    new_max = reference.progressive_splat_update_ref(
        torch.from_numpy(data), t_logits,
        *(torch.from_numpy(s) for s in state))[2]
    return data, logits, state, cts, t_logits, new_max


def _jax_ddata(data, logits, state, cts, jdt):
    """d_data of the JAX package's ``xla`` gradient: the cotangents of the
    new sums, none on the new max."""
    jl = jnp.asarray(logits).astype(jdt)
    _, vjp = jax.vjp(lambda d: jops.progressive_splat_update(
        d, jl, *map(jnp.asarray, state), backend="xla"), jnp.asarray(data))
    bs, _, h, w = data.shape
    return vjp((jnp.asarray(cts[0]), jnp.asarray(cts[1]),
                jnp.zeros((bs, 1, h, w), jnp.float32)))[0]


@pytest.mark.parametrize("c,shape,k,groups", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_work_items_match_plain_and_jax(c, shape, k, groups, tdt, jdt):
    data, logits, state, cts, t_logits, new_max = _case(
        c, shape, k, tdt, 80 + k + c + shape[1])
    d_r = torch.from_numpy(cts[0])
    got = _tiles(t_logits, new_max, d_r, groups)
    _close(got, reference.progressive_splat_ddata_ref(t_logits, new_max,
                                                      d_r).numpy())
    _close(got, _jax_ddata(data, logits, state, cts, jdt))


@pytest.mark.parametrize("c,shape,k", [(3, (9, 16), 3), (2, (13, 8), 5),
                                       (3, (7, 40), 5)])
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_work_items_match_pallas_interpret(c, shape, k, tdt, jdt):
    """The Pallas kernel ``_psb_ddata_kernel`` itself, in interpret mode, on
    the same running max (k = 21 interprets too slowly for a test; the
    ``xla`` comparison above covers it)."""
    data, logits, state, cts, t_logits, new_max = _case(
        c, shape, k, tdt, 90 + k + c)
    d_r = torch.from_numpy(cts[0])
    want, _ = pallas_kernels.progressive_splat_bwd_pallas(
        jnp.asarray(data), jnp.asarray(logits).astype(jdt),
        jnp.asarray(new_max.numpy()), jnp.asarray(cts[0]),
        jnp.asarray(cts[1]), interpret=True)
    for groups in (1, 2, 4, 8):
        if groups <= k:
            _close(_tiles(t_logits, new_max, d_r, groups), want)


def test_host_build_refuses_what_the_vector_kernel_does_not_take():
    lib = _build.load_host()

    def run(c, w, k, groups, dtype=torch.float32):
        lg = torch.zeros(1, k * k, 4, w, dtype=dtype)
        z, one = torch.zeros(1, c, 4, w), torch.zeros(1, 1, 4, w)
        return lib.sbmc_progressive_splat_ddata_tiles_host(
            lg.data_ptr(), int(dtype == torch.bfloat16), one.data_ptr(),
            z.data_ptr(), z.data_ptr(), 1, c, 4, w, k, groups)

    assert run(3, 8, 5, 4) == 0
    assert run(3, 8, 7, 1) == 1               # k outside the template set
    assert run(3, 6, 5, 1) == 1               # w not a multiple of 4
    assert run(3, 12, 5, 1, torch.bfloat16) == 1  # nor of 8 in bfloat16
    assert run(4, 8, 5, 1) == 1               # channels
    assert run(3, 8, 5, 8) == 1               # more groups than tap rows
    assert run(3, 8, 5, 3) == 1 and run(3, 8, 5, 0) == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_path_shape_takes_the_vector_kernel():
    """Every shape the paths give the splat step (the gradient phase's
    48x48 input among them) and a full 1080x2048 tile: the vector kernel,
    with a group count the kernel takes."""
    shapes = [s[:5] for s in _chip_smoke().PATH_SHAPES]
    shapes += [(1, 3, 1080, 2048, torch.bfloat16),
               (1, 3, 1080, 2048, torch.float32)]
    for bs, c, h, w, dtype in shapes:
        size = torch.empty((), dtype=dtype).element_size()
        assert ops.splat_route(w, 21, size) == "tiled", (h, w, dtype)
        assert ops.ddata_groups(bs, h, w, 21, size, 132) in (1, 2, 4, 8)


def test_group_choices():
    # The training batch: 4 groups (256 four-row tiles) in float32, 8 (256
    # four-row tiles) in bfloat16; a 1080x2048 tile: 1 group; the default
    # CLI's 512x512 tile: 2 in bfloat16; small tiles (the gradient phase's
    # 48x48, the evaluation path's 160x160): the most, 8.
    for args, g in (((4, 128, 128, 21, 4), 4), ((4, 128, 128, 21, 2), 8),
                    ((1, 1080, 2048, 21, 2), 1), ((1, 1080, 2048, 21, 4), 1),
                    ((1, 512, 512, 21, 2), 2), ((1, 48, 48, 21, 4), 8),
                    ((1, 160, 160, 21, 2), 8)):
        assert ops.ddata_groups(*args, 132) == g, args
    # Never more groups than tap rows.
    assert ops.ddata_groups(1, 8, 64, 3, 4, 132) == 2
    assert ops.ddata_groups(1, 8, 64, 5, 4, 132) == 4
