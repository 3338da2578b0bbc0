"""The vector scatter2gather kernel's work items and its dispatch by shape.

The card's vector kernel (``s2g_vec`` in ``csrc/scatter2gather.cu``) moves
work items of V elements (16, 8, 4 or 2 bytes, ``ops.s2g_pixels``): two
aligned source vectors, each wholly inside or outside the row, realigned by
a funnel shift that is the same for every item of a plane. Those pieces live
in ``scatter2gather.cuh`` as ``__host__ __device__`` functions, which the
g++ host build (``_build.load_host``) assembles here item by item as the
kernel does, at every item width a row takes, against
``reference.scatter2gather_ref``, the JAX package's
``scatter2gather(backend="xla")`` and its Pallas kernel ``_s2g_kernel`` in
interpret mode: bit for bit (the op only moves values). Inputs are made
from a seed with numpy.
"""

import importlib.util
import os

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]

#: (bs, (h, w), k): 16-byte rows in both types (16, 64), KPCN's 92 (8-byte
#: bfloat16 items), the gradient phase's odd 53 (1-element items), a width
#: of 2 mod 4 (30), a row narrower than the taps' reach (8 at k = 21), and
#: planes whose item count is not a multiple of a block's (7 x 53).
CASES = [(2, (9, 16), 3), (2, (7, 53), 3), (1, (13, 92), 5),
         (2, (6, 30), 5), (1, (5, 8), 21), (1, (11, 64), 21),
         (2, (4, 92), 21)]


def _vec_host(weights, v):
    lib = _build.load_host()
    bs, k2, h, w = weights.shape
    out = torch.full_like(weights, float("nan"))
    rc = lib.sbmc_scatter2gather_vec_host(
        weights.data_ptr(), weights.element_size(), out.data_ptr(), bs, h, w,
        reference.ksize_of(weights), v)
    assert rc == 0
    return out


def _widths(w, itemsize):
    """Every item width the vector kernel may take at this width."""
    widest = ops.s2g_pixels(w, itemsize, 0)
    return [v for v in (1, 2, 4, 8) if v <= widest]


def _as_torch(jx, dtype):
    return torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("bs,hw,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_vector_work_items_match_plain_and_jax(bs, hw, k, tdt, jdt):
    rng = np.random.RandomState(60 + k + hw[1])
    wts = rng.randn(bs, k * k, *hw).astype(np.float32)
    t_wts = torch.from_numpy(wts).to(tdt)
    want = reference.scatter2gather_ref(t_wts)
    jax_want = _as_torch(jops.scatter2gather(jnp.asarray(wts).astype(jdt),
                                             backend="xla"), tdt)
    assert torch.equal(want, jax_want)
    widths = _widths(hw[1], t_wts.element_size())
    assert widths[-1] * t_wts.element_size() in (2, 4, 8, 16)
    for v in widths:
        got = _vec_host(t_wts, v)
        assert got.dtype == tdt and torch.equal(got, want), v


@pytest.mark.parametrize("bs,hw,k", [(1, (7, 53), 3), (2, (13, 92), 5),
                                     (1, (6, 30), 5)])
def test_vector_work_items_match_pallas_interpret(bs, hw, k):
    """The Pallas kernel ``_s2g_kernel`` itself, in interpret mode (k = 21
    interprets 30 s a case; the ``xla`` comparison above covers it)."""
    rng = np.random.RandomState(70 + k)
    wts = rng.randn(bs, k * k, *hw).astype(np.float32)
    want = _as_torch(pallas_kernels.scatter2gather_pallas(
        jnp.asarray(wts), interpret=True), torch.float32)
    t_wts = torch.from_numpy(wts)
    for v in _widths(hw[1], 4):
        assert torch.equal(_vec_host(t_wts, v), want), v


def test_host_build_refuses_what_the_vector_kernel_does_not_take():
    lib = _build.load_host()
    z = torch.zeros(1, 49, 4, 12)

    def run(t, v, k):
        out = torch.zeros_like(t)
        return lib.sbmc_scatter2gather_vec_host(
            t.data_ptr(), t.element_size(), out.data_ptr(), 1, 4,
            t.shape[-1], k, v)

    assert run(z[:, :9].contiguous(), 4, 3) == 0
    assert run(z, 4, 7) == 1                  # k outside the template set
    assert run(z[:, :9].contiguous(), 3, 3) == 1    # 12-byte items
    assert run(z[:, :9].contiguous(), 8, 3) == 1    # 32-byte items
    assert run(torch.zeros(1, 9, 4, 10), 4, 3) == 1  # 4 does not divide 10
    zb = torch.zeros(1, 9, 4, 12, dtype=torch.bfloat16)
    assert run(zb, 4, 3) == 0 and run(zb, 8, 3) == 1
    assert lib.sbmc_scatter2gather_vec_host(
        z.data_ptr(), 8, z.data_ptr(), 1, 4, 12, 3, 1) == 1  # 8-byte type


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_path_shape_takes_the_vector_kernel():
    """scatter2gather runs on the composed gradient path (kernel_apply's
    2x37x53 input, KPCN's 28x28 tiles) and could meet any shape kernel
    weighting meets: all take the vector kernel, with 16-byte items but at
    odd widths and at widths of 8 mod 16 bytes."""
    smoke = _chip_smoke()
    shapes = [s[:4] + (s[4],)
              for s in smoke.KW_PATH_SHAPES + smoke.PATH_SHAPES]
    shapes += [(1, 3, 1080, 2048, torch.bfloat16),
               (1, 3, 1080, 2048, torch.float32)]
    assert ops.s2g_route(21) == "tiled"
    for bs, c, h, w, dtype in shapes:
        size = torch.empty((), dtype=dtype).element_size()
        nbytes = ops.s2g_pixels(w, size, 0, 0) * size
        if w % 2:
            assert nbytes == size, (w, dtype)
        elif (w * size) % 16:
            assert nbytes == 8, (w, dtype)
        else:
            assert nbytes == 16, (w, dtype)


@pytest.mark.parametrize("k,route", [(3, "tiled"), (5, "tiled"),
                                     (21, "tiled"), (1, "generic"),
                                     (7, "generic"), (9, "generic")])
def test_s2g_route(k, route):
    assert ops.s2g_route(k) == route


def test_s2g_pixels():
    assert ops.s2g_pixels(2048, 2, 0, 0) == 8
    assert ops.s2g_pixels(2048, 4, 0, 0) == 4
    assert ops.s2g_pixels(92, 2, 0, 0) == 4 and ops.s2g_pixels(92, 4, 0) == 4
    assert ops.s2g_pixels(30, 4, 0) == 2 and ops.s2g_pixels(53, 2, 0) == 1
    # Either base one element past an aligned one, or two past.
    assert ops.s2g_pixels(2048, 2, 1, 0) == 1
    assert ops.s2g_pixels(2048, 2, 0, 6) == 2
    assert ops.s2g_pixels(2048, 4, 8, 2) == 2
