"""The renderer's CUDA kernels (R1 ``ops.tri_nearest``, R2 ``ops.tri_any``,
R3 ``ops.random_uniform``) against their plain PyTorch versions, on the
card.

Marked ``cuda``: they skip on a machine without a CUDA device and run on the
GPU with ``python -m pytest --noconftest tests/test_torch_render_cuda.py -m
cuda`` (this file imports nothing of JAX).

Tolerances: R3 is bit-exact (integer arithmetic and one correctly rounded
fused multiply-add). R1's distances within 1e-5 relative (nvcc contracts
the dot products into fused multiply-adds; the plain version rounds every
operation), its index and back-face flag equal wherever the two nearest
triangles of a ray are further apart than that; a ray grazing an edge may
hit in one and miss in the other, at most 1 in 10^4 rays, as R2 may flip.
"""

import numpy as np
import pytest
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import reference
from sbmc_tpu_torch.render import pathtracer, prng, scene

T_RTOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,n", [(1, 1), (3, 255), (5, 257),
                                      (35, 16384)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (prng.NORMAL_LO, 1.0),
                                   (-2.5, 3.0)])
def test_threefry_kernel_is_exact(device, n_keys, n, lo, hi):
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in range(n_keys)])
    dk = torch.from_numpy(keys.view(np.int32)).to(device)
    ops.reset_launch_counts()
    got = ops.random_uniform(dk, n, lo, hi)
    bits = ops.random_bits(dk, n)
    assert ops.launch_counts["threefry_uniform"] == 2
    want = reference.threefry_uniform_ref(dk, n, lo, hi)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    host = bits.cpu().numpy().view(np.uint32)
    for i in range(n_keys):
        np.testing.assert_array_equal(host[i], prng.random_bits(keys[i], n))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,moving", [(0, False), (5, True)])
def test_triangle_kernels_match_plain(device, seed, moving):
    sc = scene.random_tracer_scene(np.random.RandomState(seed))
    if moving:
        sc.motion = np.random.RandomState(seed).normal(0, 0.5,
                                                       sc.motion.shape)
    tris = pathtracer.prepare_scene(sc, device)["tris"]
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 << 15
    org = (torch.tensor(sc.cam_pos, dtype=torch.float32, device=device)
           + 0.3 * torch.randn(n, 3, device=device, generator=gen))
    dirs = torch.randn(n, 3, device=device, generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 1.0
    dirs[0] = float("nan")
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    time_ = torch.rand(n, device=device, generator=gen)
    dist = 15 * torch.rand(n, device=device, generator=gen)
    ops.reset_launch_counts()
    t, idx, back = ops.tri_nearest(org, dirs, time_, tris)
    blocked = ops.tri_any(org, dirs, dist, tris)
    assert {k: v for k, v in ops.launch_counts.items() if v} == {
        "tri_nearest": 1, "tri_any": 1}
    ts, pback = reference.tri_hits_ref(org, dirs, time_, tris)
    pidx = torch.argmin(ts, 1)
    pt = ts.gather(1, pidx[:, None])[:, 0]
    close = (t - pt).abs() <= T_RTOL * pt.abs()
    assert (~close).sum() <= n // 10000
    two = torch.topk(ts, 2, dim=1, largest=False).values
    clear = close & ((two[:, 1] - two[:, 0]) > T_RTOL * two[:, 0])
    assert torch.equal(idx[clear].long(), pidx[clear])
    assert torch.equal(back[clear], pback.gather(1, pidx[:, None])[:, 0][
        clear])
    assert t[0] == reference.TRI_MISS
    want = reference.tri_any_ref(org, dirs, dist, tris)
    assert (blocked != want).sum() <= n // 10000


@pytest.mark.cuda
def test_tile_renders_on_the_card(device):
    sc = scene.random_tracer_scene(np.random.RandomState(1))
    ops.reset_launch_counts()
    stats = {}
    tile = pathtracer.render_tile_wavefront(sc, prng.PRNGKey(1), ts=32,
                                            spp=2, gt_spp=4, device=device,
                                            stats=stats)
    for arr in (tile.features, tile.pixel_data, tile.p, tile.ld):
        assert np.isfinite(arr).all()
    assert stats["device"] > 0
    # Two wavefronts (the 4 ground-truth passes, then the 2 recorded), each
    # 6 vertices of one nearest-hit and two shadow tests, and one uniform
    # and one normal draw.
    assert {k: v for k, v in ops.launch_counts.items() if v} == {
        "tri_nearest": 12, "tri_any": 24, "threefry_uniform": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("n_meshes", [0, 2, 4])
def test_tiled_and_generic_triangle_kernels_agree(device, n_meshes):
    """The tiled kernels against the generic ones, which they replace on
    every path, and the routes: up to ops.TRI_TILED_MAX triangles tiled.
    The tiled kernels decide every returned value with th_finish, the
    generic ones' arithmetic, so they may differ only where nvcc contracts
    the two differently: at most 1 ray in 10^4."""
    sc = scene.random_tracer_scene(np.random.RandomState(3),
                                   n_meshes=n_meshes, obj_prob=1.0)
    tris = pathtracer.prepare_scene(sc, device)["tris"]
    assert ops.tri_route(tris.shape[0]) == "tiled"
    assert ops.tri_route(ops.TRI_TILED_MAX + 1) == "generic"
    gen = torch.Generator(device=device).manual_seed(n_meshes)
    n = (1 << 15) + 17
    org = (torch.tensor(sc.cam_pos, dtype=torch.float32, device=device)
           + 0.3 * torch.randn(n, 3, device=device, generator=gen))
    dirs = torch.randn(n, 3, device=device, generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 1.0
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    time_ = torch.rand(n, device=device, generator=gen)
    dist = 15 * torch.rand(n, device=device, generator=gen)
    ops.reset_launch_counts()
    want_t = ops._tri_nearest_cuda(org, dirs, time_, tris, route="generic")
    want_any = ops._tri_any_cuda(org, dirs, dist, tris, route="generic")
    t, idx, back = ops.tri_nearest(org, dirs, time_, tris)
    same = ((t.view(torch.int32) == want_t[0].view(torch.int32))
            & (idx == want_t[1]) & (back == want_t[2]))
    assert (~same).sum() <= n // 10000
    blocked = ops.tri_any(org, dirs, dist, tris)
    assert (blocked != want_any).sum() <= n // 10000
    if tris.shape[0]:
        assert {k: v for k, v in ops.launch_counts.items() if v} == {
            "tri_nearest": 1, "tri_nearest_generic": 1, "tri_any": 1,
            "tri_any_generic": 1}
