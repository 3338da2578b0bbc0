"""The renderer's triangle kernels R1 (``ops.tri_nearest``) and R2
(``ops.tri_any``) through the host builds of their header
``csrc/trace_hits.cuh``, against their plain PyTorch versions and against
the JAX renderer's ``_tri_ts``, ``_intersect`` and ``_occluded``.

Tolerances:

- host build against plain version: bit for bit. Both sum the three
  products of each dot product x, y, z in that order with every operation
  rounded (g++ emits no fused multiply-add for the default x86-64 target,
  and PyTorch's CPU kernels round each elementwise operation).
- against JAX: XLA forms the dot products as float32 matrix products and
  contracts ``a * b + c`` into fused multiply-adds, so ``t`` moves by ulps:
  relative 1e-5. Where the two nearest triangles of a ray lie within that
  bound of each other, the index may differ; elsewhere it must not. A ray
  that grazes an edge may hit in one and miss in the other: every ray whose
  distances disagree must pass within EDGE (in barycentric units, computed
  in float64) of the edge of the triangle either one hit.
"""

import ctypes
import importlib.util
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.render import assets as jassets
from sbmc_tpu.render import pathtracer as jpt
from sbmc_tpu_torch.ops import _build, reference
from sbmc_tpu_torch.render import assets, pathtracer, scene

T_RTOL = 1e-5
EDGE = 1e-4


def _scene(module, seed, moving=False, meshes=2):
    pools = module.ObjPool("assets/objs") if meshes else None
    sc = (jpt if module is jassets else scene).random_tracer_scene(
        np.random.RandomState(seed), obj_pool=pools, n_meshes=meshes,
        obj_prob=1.0)
    if moving:
        # Every primitive moves, the meshes too (their slots are last).
        sc.motion = np.random.RandomState(seed + 1).normal(
            0, 0.5, sc.motion.shape)
    return sc


def _rays(sc, n=1500, seed=0):
    """Rays from around the camera towards the centroids of the meshes' real
    (non-padding) triangles, jittered, a tenth at random, plus: a NaN ray, a ray parallel to the first triangle's
    plane, rays through a vertex, an edge midpoint and the hypotenuse of
    the first real triangle, and shutter times in [0, 1)."""
    rng = np.random.RandomState(seed)
    org = (sc.cam_pos[None] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    real = np.abs(np.cross(sc.tri_e1, sc.tri_e2)).sum(1) > 0
    cent = (sc.tri_v0 + (sc.tri_e1 + sc.tri_e2) / 3)[real]
    if not len(cent):
        cent = sc.centers
    target = cent[rng.randint(0, len(cent), n)] + rng.normal(0, 0.1, (n, 3))
    target[: n // 10] = rng.normal(0, 5, (n // 10, 3))
    dirs = target - org
    if len(sc.tri_v0):
        v0, e1, e2 = sc.tri_v0[0], sc.tri_e1[0], sc.tri_e2[0]
    else:
        v0, e1, e2 = sc.centers[0], np.eye(3)[0], np.eye(3)[1]
    special_t = [v0, v0 + 0.5 * e1, v0 + 0.5 * (e1 + e2)]
    o = sc.cam_pos
    extra_o = [o, o, o, o]
    extra_d = [np.full(3, np.nan)] + [p - o for p in special_t]
    extra_o.append(v0 - 2.0 * np.cross(e1, e2))       # parallel to the face
    extra_d.append(e1)
    org = np.concatenate([org, np.array(extra_o, np.float32)])
    dirs = np.concatenate([dirs, np.array(extra_d)])
    with np.errstate(invalid="ignore"):
        dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
            np.float32)
    time = rng.rand(len(org)).astype(np.float32)
    return org, dirs, time


def _host_nearest(org, dirs, time, tris):
    lib = _build.load_host()
    n = len(org)
    t = np.empty(n, np.float32)
    idx = np.empty(n, np.int32)
    back = np.empty(n, np.uint8)
    tris = np.ascontiguousarray(tris, np.float32)
    assert lib.sbmc_tri_nearest_host(
        org.ctypes.data, dirs.ctypes.data, time.ctypes.data, tris.ctypes.data,
        n, len(tris), t.ctypes.data, idx.ctypes.data, back.ctypes.data) == 0
    return t, idx, back.astype(bool)


def _host_any(org, dirs, dist, tris):
    lib = _build.load_host()
    out = np.empty(len(org), np.uint8)
    tris = np.ascontiguousarray(tris, np.float32)
    assert lib.sbmc_tri_any_host(
        org.ctypes.data, dirs.ctypes.data, dist.ctypes.data, tris.ctypes.data,
        len(org), len(tris), out.ctypes.data) == 0
    return out.astype(bool)


CASES = [(0, False, 2), (5, True, 2), (9, False, 1), (2, False, 0)]


@pytest.mark.parametrize("seed,moving,meshes", CASES)
def test_host_build_equals_plain(seed, moving, meshes):
    sc = _scene(assets, seed, moving, meshes)
    tris = pathtracer.prepare_scene(sc, "cpu")["tris"]
    org, dirs, time = _rays(sc)
    t, idx, back = _host_nearest(org, dirs, time, tris.numpy())
    want = reference.tri_nearest_ref(*map(torch.from_numpy,
                                          (org, dirs, time)), tris)
    np.testing.assert_array_equal(t.view(np.int32),
                                  want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(idx, want[1].numpy())
    np.testing.assert_array_equal(back, want[2].numpy())
    if meshes:
        assert (t < reference.TRI_MISS).sum() > len(t) // 4  # many hits
    dist = np.random.RandomState(seed).uniform(0, 15, len(org)).astype(
        np.float32)
    dist[:3] = [reference.TRI_MISS, np.nan, 0.0]
    blocked = _host_any(org, dirs, dist, tris.numpy())
    want_any = reference.tri_any_ref(torch.from_numpy(org),
                                     torch.from_numpy(dirs),
                                     torch.from_numpy(dist), tris)
    np.testing.assert_array_equal(blocked, want_any.numpy())
    if meshes:
        assert 0 < blocked.sum() < len(blocked)


def _edge_distance(sc, org, dirs, time, tri):
    """Float64 distance of each ray's crossing of triangle ``tri`` (at its
    shutter time) from the triangle's nearest edge, in barycentric units."""
    m = np.asarray(sc.motion, np.float64)[sc.tri_prim[tri]]
    v0 = sc.tri_v0[tri] + time[:, None].astype(np.float64) * m
    e1, e2 = sc.tri_e1[tri], sc.tri_e2[tri]
    o, d = org.astype(np.float64), dirs.astype(np.float64)
    pv = np.cross(d, e2)
    det = np.sum(e1 * pv, 1)
    tv = o - v0
    u = np.sum(tv * pv, 1) / det
    v = np.sum(d * np.cross(tv, e1), 1) / det
    return np.abs(np.stack([u, v, 1 - u - v], 1)).min(1)


def _assert_t_agrees(sc, org, dirs, time, t, idx, jt, jidx):
    """t within T_RTOL, except on rays that graze an edge of the triangle
    either side hit."""
    off = ~np.isclose(t, jt, rtol=T_RTOL, atol=0)
    if off.any():
        tri = np.where(t[off] < reference.TRI_MISS, idx[off], jidx[off])
        dist = _edge_distance(sc, org[off], dirs[off], time[off], tri)
        assert (dist < EDGE).all(), dist
    assert off.mean() <= 0.01


def _jax_tri(sc, org, dirs, time):
    scn = sc.as_jax()
    ts, back = jax.jit(jpt._tri_ts)(scn, jnp.asarray(org), jnp.asarray(dirs),
                                    jnp.asarray(time))
    return np.asarray(ts), np.asarray(back)


@pytest.mark.parametrize("seed,moving,meshes", CASES[:3])
def test_nearest_and_any_against_jax(seed, moving, meshes):
    """R1's host build against ``_tri_ts`` reduced as ``_intersect``
    reduces it (argmin, first index on ties), and R2's against
    ``_occluded``'s triangle test (time 0)."""
    sc_t, sc_j = _scene(assets, seed, moving, meshes), _scene(jassets, seed,
                                                              moving, meshes)
    tris = pathtracer.prepare_scene(sc_t, "cpu")["tris"].numpy()
    org, dirs, time = _rays(sc_t)
    t, idx, back = _host_nearest(org, dirs, time, tris)
    ts, jback = _jax_tri(sc_j, org, dirs, time)
    jidx = np.argmin(ts, 1)
    jt = ts[np.arange(len(ts)), jidx]
    _assert_t_agrees(sc_t, org, dirs, time, t, idx, jt, jidx)
    part = np.sort(ts, 1)
    clear = (part[:, 1] - part[:, 0]) > T_RTOL * np.abs(part[:, 0])
    clear &= (jt < reference.TRI_MISS) & np.isclose(t, jt, rtol=T_RTOL,
                                                    atol=0)
    assert clear.sum() > len(t) // 4
    np.testing.assert_array_equal(idx[clear], jidx[clear])
    np.testing.assert_array_equal(back[clear],
                                  jback[np.arange(len(ts)), jidx][clear])
    # The NaN ray misses, as every comparison with NaN is false.
    n_rand = len(org) - 5
    assert t[n_rand] == reference.TRI_MISS and jt[n_rand] == t[n_rand]

    dist = np.random.RandomState(seed).uniform(0, 15, len(org)).astype(
        np.float32)
    ts0, _ = _jax_tri(sc_j, org, dirs, np.zeros_like(time))
    want = (ts0 < dist[:, None] - np.float32(1e-3)).any(1)
    got = _host_any(org, dirs, dist, tris)
    off = got != want
    if off.any():
        # A flip needs a triangle whose distance or edge is within ulps.
        zero = np.zeros(off.sum(), np.float32)
        lim = dist[off, None] - np.float32(1e-3)
        close = np.abs(ts0[off] - lim).min(1) <= T_RTOL * dist[off]
        near_t = np.argmin(np.abs(np.where(ts0[off] < reference.TRI_MISS,
                                           ts0[off], 0) - lim), 1)
        grazes = _edge_distance(sc_t, org[off], dirs[off], zero,
                                near_t) < EDGE
        assert (close | grazes).all()
    assert off.mean() <= 0.01


@pytest.mark.parametrize("seed,moving,meshes", CASES)
def test_intersect_and_occluded_against_jax(seed, moving, meshes):
    """The port's whole ``_intersect`` (analytic primitives in PyTorch,
    triangles through ``ops.tri_nearest``) and ``_occluded`` on the CPU
    against the JAX renderer's, ray for ray. Ids and flags must agree on
    99.9% of the rays (grazing rays may flip); where the ids agree, the
    distances, hit points and normals within 1e-4."""
    sc_t, sc_j = _scene(assets, seed, moving, meshes), _scene(jassets, seed,
                                                              moving, meshes)
    org, dirs, time = _rays(sc_t, seed=seed)
    scn = pathtracer.prepare_scene(sc_t, "cpu")
    got = pathtracer._intersect(scn, *map(torch.from_numpy,
                                          (org, dirs, time)))
    want = jax.jit(jpt._intersect)(sc_j.as_jax(), jnp.asarray(org),
                                   jnp.asarray(dirs), jnp.asarray(time))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    same = got["id"] == want["id"]
    assert same.mean() >= 0.999
    for k in ("hit", "mat", "inside"):
        np.testing.assert_array_equal(got[k][same], want[k][same])
    # The analytic primitives' quadratic roots cancel near tangency, where
    # ulps of the discriminant grow to ~1e-5 of t; the normals of such hits
    # move by as much over the primitive's radius.
    for k, tol in (("t", 1e-4), ("p", 1e-4), ("normal", 1e-3),
                   ("roughness", 0.0)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=tol,
                                   atol=tol)
    # Albedo. The value-noise hash (|sin(x) * 43758.5453| % 1 at lattice
    # corners) is chaotic: an ulp of its argument or of sin changes a
    # corner's value arbitrarily, and XLA's CPU backend contracts the
    # argument's products and sums into fused multiply-adds where it fuses
    # them, so noise-textured hits may take any value of the texture's
    # range (0.4 to 1 of the base albedo). Elsewhere a hit point within
    # ulps of a checker or stripe cell edge takes the other cell's value:
    # at most 1% of those rays beyond 5e-3.
    kinds = np.append(np.asarray(sc_t.arrays()["tex_kind"]),
                      sc_t.ground_tex_kind)
    slots = np.where(got["id"] == -2, -1,
                     scn["col_slot"].numpy()[np.maximum(got["id"], 0)])
    noisy = kinds[slots] == scene.TEX_NOISE
    plain = same & ~noisy & got["hit"]
    off = np.abs(got["albedo"][plain] - want["albedo"][plain]).max(1) > 5e-3
    assert off.mean() <= 0.01
    assert np.isfinite(got["albedo"]).all() and (got["albedo"] >= 0).all()

    dist = np.random.RandomState(seed + 3).uniform(0, 15, len(org)).astype(
        np.float32)
    occ = pathtracer._occluded(scn, *map(torch.from_numpy,
                                         (org, dirs, dist))).numpy()
    jocc = np.asarray(jax.jit(jpt._occluded)(
        sc_j.as_jax(), jnp.asarray(org), jnp.asarray(dirs),
        jnp.asarray(dist)))
    assert (occ == jocc).mean() >= 0.999


def test_no_triangles_and_wrapper_checks():
    """T = 0: every ray misses and nothing blocks; the CUDA wrappers refuse
    what their kernels do not take."""
    tris = torch.zeros(0, 16)
    org, dirs = torch.zeros(4, 3), torch.ones(4, 3)
    t, idx, back = reference.tri_nearest_ref(org, dirs, torch.zeros(4), tris)
    assert (t == reference.TRI_MISS).all() and (idx == 0).all()
    assert not back.any()
    assert not reference.tri_any_ref(org, dirs, torch.ones(4), tris).any()
    from sbmc_tpu_torch import ops
    with pytest.raises(ValueError):
        ops._check_rays(org, dirs[:, :2], torch.zeros(4), torch.zeros(3, 16))
    with pytest.raises(ValueError):
        ops._check_rays(org, dirs, torch.zeros(4), torch.zeros(3, 15))


def test_argmin_takes_nan_and_first_ties_as_jax():
    """The port's nearest-hit choice is ``torch.argmin``, JAX's
    ``jnp.argmin``: both take a NaN as the minimum and the first of equal
    minima. ``_tri_ts`` and the analytic tests never give a NaN distance
    (every comparison with NaN fails, so a NaN ray's distances are the
    miss value), but the two reductions agree if one ever did."""
    ts = np.array([[3.0, np.nan, 1.0, np.nan],
                   [2.0, 1.0, 1.0, 5.0],
                   [1e10, 1e10, 1e10, 1e10]], np.float32)
    np.testing.assert_array_equal(torch.argmin(torch.from_numpy(ts),
                                               1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(ts), 1)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_float32_edge_rounding_within_the_smokes_margin():
    """chip_smoke.py lets R1 and R2 differ from their plain versions on a
    ray whose crossing lies within ``_tri_f64``'s edge margin of an edge.
    At the largest triangle bucket (small triangles seen from afar) the
    plain version's float32 barycentric margin min(u, v, 1 - u - v) is off
    float64's by more than 1e-4 on some pairs, so a fixed 1e-4 would be
    too narrow; the margin, widened by the float32 ulps of the terms u and
    v are summed from, holds every pair within half of it."""
    cs = _chip_smoke()
    sc = cs._largest_bucket_scene(
        {"obj_pool": assets.ObjPool("assets/objs")})
    tris = pathtracer.prepare_scene(sc, "cpu")["tris"]
    org, dirs, time = (torch.from_numpy(x) for x in _rays(sc, 16384, 3))
    c = tris.t()
    pairs, errs, ratios = 0, [], []
    for i in range(0, len(org), 2048):
        o, d, tt = org[i:i + 2048], dirs[i:i + 2048], time[i:i + 2048, None]

        def dot(v, a):
            return (v[:, 0:1] * c[a] + v[:, 1:2] * c[a + 1]
                    + v[:, 2:3] * c[a + 2])

        ts = (c[9] + tt * c[12] - dot(o, 0)) / dot(d, 0)
        u = dot(o, 3) - c[10] - tt * c[13] + ts * dot(d, 3)
        v = dot(o, 6) - c[11] - tt * c[14] + ts * dot(d, 6)
        m32 = torch.minimum(torch.minimum(u, v), 1 - u - v).double()
        t64, m64, _, _, edge = cs._tri_f64(tris, o, d, tt[:, 0])
        near = (m64.abs() < 0.01) & (t64 > 1e-3) & (t64 < 1e9)
        pairs += int(near.sum())
        errs.append((m32 - m64).abs()[near])
        ratios.append(errs[-1] / edge[near])
    assert pairs > 1000
    assert float(torch.cat(errs).max()) > cs.TRI_EDGE
    assert float(torch.cat(ratios).max()) <= 0.5


# ---------------------------------------------------------------------------
# The tiled kernels' loop (trace_hits.cuh: th_may_hit's division-free
# filter, then th_finish on the pairs it passes; R2 at time 0 without the
# motion products; the degenerate padding skipped) against the generic
# kernels' th_hit loop, bit for bit, through the host builds.

def _host_tiles(lib, kind, org, dirs, x, tris, rays):
    """``kind`` "nearest" or "any" through a host library's tiled loop
    (``rays`` a thread; None: the generic loop)."""
    n, t = len(org), len(tris)
    tris = np.ascontiguousarray(tris, np.float32)
    args = [org.ctypes.data, dirs.ctypes.data, x.ctypes.data,
            tris.ctypes.data, n, t]
    extra = [] if rays is None else [rays]
    suffix = "_host" if rays is None else "_tiles_host"
    if kind == "nearest":
        out = (np.empty(n, np.float32), np.empty(n, np.int32),
               np.empty(n, np.uint8))
        fn = getattr(lib, "sbmc_tri_nearest" + suffix)
        assert fn(*args, *(o.ctypes.data for o in out), *extra) == 0
        return out
    out = np.empty(n, np.uint8)
    fn = getattr(lib, "sbmc_tri_any" + suffix)
    assert fn(*args, out.ctypes.data, *extra) == 0
    return (out,)


def _planted(sc, n, seed):
    """Rays planted on the tests' decision boundaries of the real
    triangles (at time 0, where the triangles stand as packed): through a
    vertex or a point of an edge (u = 0, v = 0, u + v = 1) from 0.5 or 1e-3
    (the t floor) away, some grazing (along an edge, tilted out of the
    plane by 1e-3 or 1e-6); and R2 distances that put each crossing at
    dist - 1e-3 within ulps."""
    rng = np.random.RandomState(seed)
    real = np.nonzero(np.abs(np.cross(sc.tri_e1, sc.tri_e2)).sum(1) > 0)[0]
    tri = rng.choice(real, n)
    v0, e1, e2 = (np.asarray(a, np.float64)[tri]
                  for a in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    s = rng.rand(n, 1)
    kind = rng.randint(0, 4, n)
    s[kind == 3] = rng.randint(0, 2, ((kind == 3).sum(), 1))  # vertices
    p = np.where((kind == 0)[:, None], v0 + s * e1,
                 np.where((kind == 1)[:, None], v0 + s * e2,
                          v0 + s * e1 + (1 - s) * e2))
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rng.normal(size=(n, 3))
    graze = rng.rand(n) < 0.25
    tilt = np.where(rng.rand(n) < 0.5, 1e-3, 1e-6)[:, None]
    along = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    d[graze] = (along + tilt * nrm)[graze]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = np.where(rng.rand(n) < 0.2, 1e-3, 0.5)[:, None]
    org = (p - length * d).astype(np.float32)
    dirs = d.astype(np.float32)
    dist = (length[:, 0] + 1e-3).astype(np.float32)
    return org, dirs, np.zeros(n, np.float32), dist


def _hit_cases():
    """(scene, org, dirs, time, dist): the CPU tests' random rays (hits,
    misses, a NaN ray, a parallel one, rays through a vertex, an edge and
    the hypotenuse) and planted ones, at the largest bucket (1024
    triangles), on a moving mesh and on analytic-only and 1-mesh scenes."""
    pools = {"obj_pool": assets.ObjPool("assets/objs")}
    big = _chip_smoke()._largest_bucket_scene(pools)
    # One of its two meshes moves, the other stands: the tiled R1 tests
    # the standing one's triangles without the motion terms.
    big.motion = np.zeros_like(big.motion)
    big.motion[big.tri_prim[0]] = [0.3, -0.2, 0.1]
    scenes = [(big, 2000), (_scene(assets, 5, True), 1500),
              (_scene(assets, 9, False, 1), 1500)]
    for i, (sc, n) in enumerate(scenes):
        org, dirs, time = _rays(sc, n, seed=i)
        dist = np.random.RandomState(i).uniform(0, 15, len(org)).astype(
            np.float32)
        dist[:3] = [reference.TRI_MISS, np.nan, 0.0]
        po, pd, pt, pdist = _planted(sc, n, 100 + i)
        # Times that are not finite miss everything, planted hits too.
        pt[::20], pt[1::20], pt[2::20] = np.nan, np.inf, -np.inf
        yield (sc, np.concatenate([org, po]), np.concatenate([dirs, pd]),
               np.concatenate([time, pt]), np.concatenate([dist, pdist]))


def _same(got, want):
    return all(np.array_equal(g.view(np.uint8), w.view(np.uint8))
               for g, w in zip(got, want))


@pytest.mark.parametrize("rays", [1, 2, 4])
def test_tiled_loop_is_the_generic_loop_bit_for_bit(rays):
    """Over more than 10^6 ray x triangle pairs, the filtered loop gives
    the generic loop's distances, indices, back-face flags and shadow
    results bit for bit: the filter drops no pair that th_hit accepts
    (NaN, parallel, grazing rays, crossings on edges and vertices, at the
    1e-3 floor and at the shadow ray's limit), R2's time-0 terms without
    the motion products change nothing on moving meshes, R1's test of a
    standing mesh without them changes nothing at any time (rays whose
    time is not finite included), and skipping the degenerate padding
    changes nothing."""
    lib = _build.load_host()
    pairs = 0
    for sc, org, dirs, time, dist in _hit_cases():
        tris = pathtracer.prepare_scene(sc, "cpu")["tris"].numpy()
        pairs += len(org) * len(tris)
        for kind, x in (("nearest", time), ("any", dist)):
            want = _host_tiles(lib, kind, org, dirs, x, tris, None)
            got = _host_tiles(lib, kind, org, dirs, x, tris, rays)
            assert _same(got, want), (kind, len(tris))
        if len(tris) == 1024:
            # The padding really is skipped: the bucket's last triangles
            # are degenerate.
            assert not np.abs(tris[-1, :3]).any()
    assert pairs > 10 ** 6


def test_a_filter_without_its_margin_fails_on_the_planted_rays(tmp_path):
    """The mutant: the host build with the filter's margin K set to 0 (so
    it drops a pair as soon as the approximate u, v or t fall outside)
    differs from the generic loop on the planted edge rays, which shows the
    equality above can catch a filter that is not conservative."""
    cxx = shutil.which("g++") or shutil.which("c++")
    out = str(tmp_path / "libtrace_hits_k0.so")
    subprocess.run([cxx] + _build.HOST_FLAGS + ["-DTH_FILTER_K=0.0f", "-o",
                   out, os.path.join(_build.CSRC, "trace_hits_host.cpp")],
                   check=True)
    mutant = ctypes.CDLL(out)
    lib = _build.load_host()
    for name in ("sbmc_tri_nearest_tiles_host", "sbmc_tri_any_tiles_host"):
        fn = getattr(mutant, name)
        fn.argtypes = getattr(lib, name).argtypes
    differ = {"nearest": 0, "any": 0}
    for sc, org, dirs, time, dist in _hit_cases():
        tris = pathtracer.prepare_scene(sc, "cpu")["tris"].numpy()
        for kind, x in (("nearest", time), ("any", dist)):
            want = _host_tiles(lib, kind, org, dirs, x, tris, None)
            got = _host_tiles(mutant, kind, org, dirs, x, tris, 4)
            assert _same(_host_tiles(lib, kind, org, dirs, x, tris, 4),
                         want)
            differ[kind] += int((got[0] != want[0]).sum())
    assert differ["nearest"] > 0 and differ["any"] > 0, differ
