"""Wavefront path tracer for sample-data generation (counterpart of
``sbmc_tpu/render/pathtracer.py``).

One ray per pixel per sample pass, a fixed depth of ``MAX_DEPTH`` path
vertices (no russian roulette), next-event estimation to one spherical
light multiple-importance-sampled against BSDF sampling, and the full
per-sample record of the ``.bin`` format: 27 sample features, four MIS
pdfs, two light-direction angles and a bounce-type bitmask per vertex.
The scene model is :mod:`sbmc_tpu_torch.render.scene`.

The JAX renderer's ``lax.scan`` over vertices is a Python loop here and its
``lax.cond`` on the aperture a host ``if``. Its work runs as PyTorch tensor
code on the scene's device, except for three hand-written kernels
(:mod:`sbmc_tpu_torch.ops`): ``tri_nearest`` and ``tri_any`` test every
ray against every triangle in one fused pass each (the nearest hit a vertex,
and the two shadow rays a vertex), and ``random_uniform`` expands the
``jax.random`` keys of a batch of passes, derived on the host
(:mod:`sbmc_tpu_torch.render.prng`), into their uniforms bit for bit. On
CPU tensors the plain PyTorch versions of those kernels run instead.

Passes are traced in batches: ``B`` passes of one or more tiles form one
wavefront of ``B * ts * ts`` rays (``_WAVEFRONT_RAYS`` bounds it), each
pass with its own keys, so every pass records what it records when traced
alone. The ground-truth passes then fold into the Welford statistics in
pass order. Float32 matrix products run in full float32 (no TF32) while a
tile renders, whatever the caller set.

Numerics against the JAX renderer: the random uniforms, the scene arrays
and the arithmetic order are the same; ``sin``, ``cos``, ``pow``, ``acos``,
``atan2``, ``erfinv`` and the matrix products differ by ulps between XLA,
PyTorch's CPU kernels and CUDA, which the value-noise texture hash amplifies
and which can flip a path at an edge. The tests state the share of samples
allowed to differ and why.
"""

import contextlib
import math
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.data import bin_format
from sbmc_tpu_torch.render import prng
from sbmc_tpu_torch.render.scene import (BT_DIFFUSE, BT_GLOSSY, BT_REFLECTION,
                                         BT_SPECULAR, BT_TRANSMISSION,
                                         MAT_DIFFUSE, MAT_GLASS, MAT_METAL,
                                         MAT_MIRROR, MAT_PLASTIC, MAX_DEPTH,
                                         TEX_NOISE, TEX_STRIPES, TracerScene,
                                         random_tracer_scene)
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["TracerScene", "random_tracer_scene", "prepare_scene",
           "render_pass", "render_tile_wavefront", "render_tiles_wavefront",
           "generate_wavefront_dataset", "pass_keys", "MAX_RAY_FACTOR"]

SAMPLE_FEATURE_IDX = {n: i for i, n in
                      enumerate(bin_format.SAMPLE_FEATURE_LABELS)}
PIXEL_DEPTH_IDX = bin_format.PIXEL_CHANNEL_LABELS.index("depth")

#: Rays are truncated at this multiple of the scene radius (grazing hits on
#: the infinite ground plane would otherwise record unbounded depths).
MAX_RAY_FACTOR = 4.0

_INF = 1e10
#: Share of plastic samples that pick the diffuse base lobe (vs the coat).
_PLASTIC_DIFFUSE_P = 0.7
#: Rays of one traced wavefront: passes are batched up to this many rays
#: (64 passes of a 128x128 tile; ~1-2 GB of device memory for the tracer's
#: temporaries at that width).
_WAVEFRONT_RAYS = 1 << 20
#: Uniform draws of one pass, in the order the key schedule lists them: the
#: five camera draws (pixel jitter x and y, lens radius and angle, shutter
#: time), then per vertex the cosine lobe's two, the Phong lobe's two and
#: the Fresnel / plastic-lobe choice.
_CAMERA_DRAWS = 5
_VERTEX_DRAWS = 5
_UNIFORM_DRAWS = _CAMERA_DRAWS + MAX_DEPTH * _VERTEX_DRAWS


# ---------------------------------------------------------------------------
# Keys (host, numpy uint32)

def pass_keys(key):
    """The keys of every ``jax.random`` draw of the passes traced from
    ``key`` (``[..., 2]``: one pass a key), in the JAX renderer's derivation
    (``render_pass``: ``split(key, 8)``, then per vertex ``fold_in`` and
    ``split(., 4)``), for all passes at once.

    Returns ``(uniform [..., _UNIFORM_DRAWS, 2], normal [..., MAX_DEPTH,
    2])`` uint32: the keys of the uniform draws of ``n`` values (listed as
    ``_UNIFORM_DRAWS`` says) and of each vertex's ``[n, 3]`` normal draw
    (``_sphere_dir``'s)."""
    keys = prng.split(key, 8)
    uni = [keys[..., i, :] for i in range(_CAMERA_DRAWS)]
    nrm = []
    for d in range(MAX_DEPTH):
        k4 = prng.split(prng.fold_in(keys[..., 5, :], d), 4)
        nrm.append(prng.split(k4[..., 0, :])[..., 0, :])
        bsdf, lobe = prng.split(k4[..., 1, :]), prng.split(k4[..., 2, :])
        uni.extend([bsdf[..., 0, :], bsdf[..., 1, :], lobe[..., 0, :],
                    lobe[..., 1, :], k4[..., 3, :]])
    return np.stack(uni, -2), np.stack(nrm, -2)


def _tile_keys(key, spp, gt_spp):
    """``(recorded, ground truth)`` pass keys of one tile: ``split(key,
    gt_spp + spp)``, the first ``spp`` for the recorded passes."""
    keys = prng.split(key, gt_spp + spp)
    return keys[:spp], keys[spp:spp + gt_spp]


def _upload(array, device):
    """A host array on ``device`` without waiting for the device: through
    pinned memory, copied on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# Scene on the device

def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    """Sum over the last axis of ``a * b``, x + y then z."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def prepare_scene(scene, device):
    """The scene's arrays on ``device`` (:meth:`TracerScene.as_torch`) and
    what the JAX renderer derives from them inside every call: the packed
    triangle constants of ``ops.tri_nearest`` / ``ops.tri_any``
    (``"tris"``, ``[T, 16]``), the unit triangle normals (``"tri_normal"``)
    and whether the camera has a lens (``"lens"``, a bool)."""
    scn = scene.as_torch(device)
    e1, e2, v0 = scn["tri_e1"], scn["tri_e2"], scn["tri_v0"]
    n = _cross(e1, e2)
    nn = _dot(n, n)[:, None]
    inv_nn = torch.where(nn > 1e-18, 1.0 / torch.clamp_min(nn, 1e-18), 0.0)
    g1 = _cross(e2, n) * inv_nn
    g2 = _cross(n, e1) * inv_nn
    m = scn["motion"][scn["tri_prim"].long()]
    consts = [_dot(n, v0), _dot(g1, v0), _dot(g2, v0), _dot(n, m),
              _dot(g1, m), _dot(g2, m), torch.zeros_like(nn[:, 0])]
    scn["tris"] = torch.cat([n, g1, g2, torch.stack(consts, 1)],
                            1).contiguous()
    scn["tri_normal"] = n / (_norm(n)[:, None] + 1e-12)
    # The JAX renderer's lax.cond on the aperture, decided on the host.
    scn["lens"] = bool(np.float32(scene.aperture) > 0)
    return scn


# ---------------------------------------------------------------------------
# Intersections

def _sphere_ts(scn, org, dirs, t):
    """Sphere hit distances [N, S] (entry root, or exit root when inside),
    the inside flags and the moved centers."""
    ns = scn["radii"].shape[0]
    c = scn["centers"][None] + t[:, None, None] * scn["motion"][None, :ns]
    oc = org[:, None, :] - c                       # [N, S, 3]
    b = _dot(oc, dirs[:, None, :])                 # [N, S]
    cc = _dot(oc, oc) - scn["radii"][None] ** 2
    disc = b * b - cc
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near, t_far = -b - root, -b + root
    inside = (disc > 0) & (t_near <= 1e-3) & (t_far > 1e-3)
    ts = torch.where(disc > 0,
                     torch.where(t_near > 1e-3, t_near,
                                 torch.where(inside, t_far, _INF)), _INF)
    return ts, inside, c


def _box_ts(scn, org, dirs, t):
    """Axis-aligned box hit distances [N, B], inside flags, centers."""
    nb = scn["box_centers"].shape[0]
    ns = scn["radii"].shape[0]
    cb = (scn["box_centers"][None]
          + t[:, None, None] * scn["motion"][None, ns:ns + nb])
    inv = torch.where(dirs.abs() > 1e-9, 1.0 / dirs,
                      torch.where(dirs >= 0, 1e9, -1e9))
    o = org[:, None, :] - cb                        # [N, B, 3]
    t1 = (-scn["box_half"][None] - o) * inv[:, None, :]
    t2 = (scn["box_half"][None] - o) * inv[:, None, :]
    tn = torch.amax(torch.minimum(t1, t2), -1)
    tf = torch.amin(torch.maximum(t1, t2), -1)
    valid = (tf > torch.clamp_min(tn, 1e-3)) & (tf > 1e-3)
    inside = valid & (tn <= 1e-3)
    ts = torch.where(valid, torch.where(inside, tf, tn), _INF)
    return ts, inside, cb


def _cyl_ts(scn, org, dirs, t):
    """Capped y-axis cylinder hit distances [N, C] (side quadratic clipped
    to the height, and the two cap discs), inside flags, centers."""
    ns = scn["radii"].shape[0]
    nb = scn["box_centers"].shape[0]
    nc = scn["cyl_radius"].shape[0]
    cc = (scn["cyl_centers"][None]
          + t[:, None, None] * scn["motion"][None, ns + nb:ns + nb + nc])
    o = org[:, None, :] - cc                       # [N, C, 3]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    a = dx * dx + dz * dz
    b = o[..., 0] * dx + o[..., 2] * dz
    r2 = scn["cyl_radius"][None] ** 2
    c_ = o[..., 0] ** 2 + o[..., 2] ** 2 - r2
    disc = b * b - a * c_
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    sa = torch.clamp_min(a, 1e-12)
    half = scn["cyl_half"][None]

    def side_ok(ts):
        y = o[..., 1] + ts * dy
        return (disc > 0) & (ts > 1e-3) & (y.abs() <= half)

    def cap_ok(ts):
        x = o[..., 0] + ts * dx
        z = o[..., 2] + ts * dz
        return (ts > 1e-3) & (x * x + z * z <= r2)

    t1, t2 = (-b - root) / sa, (-b + root) / sa
    inv_dy = torch.where(dy.abs() > 1e-9, 1.0 / dy,
                         torch.where(dy >= 0, 1e12, -1e12))
    tc1 = (half - o[..., 1]) * inv_dy
    tc2 = (-half - o[..., 1]) * inv_dy
    cand = torch.stack([torch.where(side_ok(t1), t1, _INF),
                        torch.where(side_ok(t2), t2, _INF),
                        torch.where(cap_ok(tc1), tc1, _INF),
                        torch.where(cap_ok(tc2), tc2, _INF)], 0)
    ts = torch.amin(cand, 0)
    inside = (c_ < 0) & (o[..., 1].abs() < half) & (ts < _INF)
    return ts, inside, cc


def _take(x, idx):
    """``x[i, idx[i]]`` for ``x`` [N, K, ...] (indices already in range)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _to_int32(x):
    """XLA's float32 -> int32 conversion: NaN -> 0, out-of-range values
    saturate (a plain cast of those is undefined in C++ and CUDA)."""
    big = x >= 2147483648.0
    y = torch.where(torch.isnan(x), 0.0, x)
    y = torch.clamp(y, -2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(big, 2147483647, y)


def _intersect(scn, org, dirs, t):
    """Nearest hit of rays [N, 3] at shutter times t [N]: the hit dict of
    the JAX renderer's ``_intersect``."""
    n_rays = org.shape[0]
    t_max = scn["scene_radius"] * MAX_RAY_FACTOR
    ns = scn["radii"].shape[0]
    nb = scn["box_centers"].shape[0]
    nc = scn["cyl_radius"].shape[0]
    nt = scn["tris"].shape[0]

    # Ground plane y = 0 (treated as environment beyond t_max).
    dy = dirs[:, 1]
    tg = torch.where(dy.abs() > 1e-8, -org[:, 1] / dy, _INF)
    tg = torch.where((tg > 1e-3) & (tg < t_max), tg, _INF)

    ts_s, in_s, c_s = _sphere_ts(scn, org, dirs, t)
    ts_all, inside_all = [ts_s], [in_s]
    if nb > 0:
        ts_b, in_b, c_b = _box_ts(scn, org, dirs, t)
        ts_all.append(ts_b)
        inside_all.append(in_b)
    if nc > 0:
        ts_c, in_c, c_c = _cyl_ts(scn, org, dirs, t)
        ts_all.append(ts_c)
        inside_all.append(in_c)
    ts_all = torch.cat(ts_all, 1)                   # [N, S+B+C]
    inside_all = torch.cat(inside_all, 1)
    p_idx = torch.argmin(ts_all, 1)                 # first index wins ties
    p_t = _take(ts_all, p_idx)
    p_inside = _take(inside_all, p_idx)
    if nt > 0:
        # jnp.argmin over [analytic | triangles]: the analytic minimum wins
        # unless a triangle is strictly nearer.
        t_tri, i_tri, back = ops.tri_nearest(org, dirs, t, scn["tris"])
        use_a = p_t <= t_tri
        p_idx = torch.where(use_a, p_idx, ns + nb + nc + i_tri.long())
        p_t = torch.where(use_a, p_t, t_tri)
        p_inside = torch.where(use_a, p_inside, back)

    hit_prim = p_t < tg
    best_t = torch.where(hit_prim, p_t, tg)
    hit = best_t < _INF
    # id: -1 = miss, -2 = ground, >= 0 = primitive
    hid = torch.where(hit, torch.where(hit_prim, p_idx, -2), -1)

    p = org + best_t[:, None] * dirs

    # Sphere outward normal.
    s_idx = torch.clamp(p_idx, 0, ns - 1)
    sc = _take(c_s, s_idx)
    n_sphere = (p - sc) / torch.clamp_min(scn["radii"][s_idx][:, None],
                                          1e-8)
    n_prim = n_sphere
    if nb > 0:
        # Box outward normal: dominant axis of the local coordinates.
        b_idx = torch.clamp(p_idx - ns, 0, nb - 1)
        bc = _take(c_b, b_idx)
        q = (p - bc) / torch.clamp_min(scn["box_half"][b_idx], 1e-8)
        ax = torch.argmax(q.abs(), -1)
        n_box = (torch.nn.functional.one_hot(ax, 3).to(q.dtype)
                 * torch.sign(_take(q, ax))[:, None])
        n_prim = torch.where((p_idx < ns)[:, None], n_prim, n_box)
    if nc > 0:
        # Cylinder outward normal: cap (+-y) vs side (radial), picked by
        # which normalized local coordinate sits on its surface (~1).
        cy_idx = torch.clamp(p_idx - ns - nb, 0, nc - 1)
        q = p - _take(c_c, cy_idx)
        half = torch.clamp_min(scn["cyl_half"][cy_idx], 1e-8)
        rad = torch.clamp_min(scn["cyl_radius"][cy_idx], 1e-8)
        u = q[:, 1].abs() / half
        rxz = torch.sqrt(q[:, 0] ** 2 + q[:, 2] ** 2)
        v = rxz / rad
        zero = torch.zeros_like(q[:, 0])
        side = (torch.stack([q[:, 0], zero, q[:, 2]], -1)
                / torch.clamp_min(rxz, 1e-8)[:, None])
        cap = torch.stack([zero, torch.sign(q[:, 1]), zero], -1)
        n_cyl = torch.where((u > v)[:, None], cap, side)
        n_prim = torch.where((p_idx < ns + nb)[:, None], n_prim, n_cyl)
    if nt > 0:
        # Triangle geometric normal (two-sided; flipped towards the ray
        # below like every other primitive).
        t_idx = torch.clamp(p_idx - ns - nb - nc, 0, nt - 1)
        n_prim = torch.where((p_idx < ns + nb + nc)[:, None], n_prim,
                             scn["tri_normal"][t_idx])
    up = torch.eye(3, device=org.device)[1]
    n_geo = torch.where(hit_prim[:, None], n_prim, up)
    # Shading normal faces the incoming ray.
    normal = torch.where(_dot(n_geo, dirs)[:, None] > 0, -n_geo, n_geo)

    # Albedo: textured ground and primitives. Material lookups go through
    # the column -> slot map (triangles share their mesh's slot).
    slot = scn["col_slot"][p_idx].long()
    # The ground's y lattice coordinate is pinned to mid-cell, so its
    # texture depends on x and z only.
    g_q = p * scn["ground_tex_scale"]
    g_q = torch.stack([g_q[:, 0], torch.full_like(g_q[:, 1], 0.5),
                       g_q[:, 2]], -1)
    g_mod = _tex_mod(scn["ground_tex_kind"], g_q, 0.0)
    g_alb = scn["ground_albedo"][None] * g_mod[:, None]
    a_prim = scn["albedos"][slot]
    freq = scn["tex_scale"][slot]
    mod = _tex_mod(scn["tex_kind"][slot], p * freq[:, None],
                   slot.to(torch.float32) * 2.39996)
    a_prim = torch.where((freq > 0)[:, None], a_prim * mod[:, None], a_prim)
    if scn["tex_images"].shape[0] > 0:
        # Image textures: RGB modulation of the slot albedo, projected along
        # the dominant geometric-normal axis.
        tid = scn["tex_image_id"][slot]
        iscale = torch.where(freq > 0, freq, 1.0)
        qi = p * iscale[:, None]
        axis = torch.argmax(n_geo.abs(), 1)
        u = torch.where(axis == 0, qi[:, 1], qi[:, 0])
        v = torch.where(axis == 2, qi[:, 1], qi[:, 2])
        rgb = _sample_image_stack(scn["tex_images"], tid, u, v)
        a_prim = torch.where((tid >= 0)[:, None], scn["albedos"][slot] * rgb,
                             a_prim)
        gid = scn["ground_tex_image_id"]
        g_rgb = _sample_image_stack(scn["tex_images"],
                                    gid.expand(n_rays), g_q[:, 0], g_q[:, 2])
        g_alb = torch.where(gid >= 0, scn["ground_albedo"][None] * g_rgb,
                            g_alb)
    albedo = torch.where(hit_prim[:, None], a_prim, g_alb)
    albedo = torch.where(hit[:, None], albedo, 0.0)

    mat = torch.where(hit_prim, scn["mat_type"][slot], MAT_DIFFUSE)
    mat = torch.where(hit, mat, MAT_DIFFUSE)
    rough = torch.where(hit_prim, scn["roughness"][slot], 1.0)
    inside = hit_prim & p_inside

    return {"hit": hit, "id": hid, "t": torch.where(hit, best_t, 0.0),
            "p": p, "normal": normal, "albedo": albedo, "mat": mat,
            "roughness": rough, "inside": inside}


def _occluded(scn, org, dirs, dist):
    """Any primitive closer than ``dist`` (the geometry at time 0: shadow
    rays test the static scene, as the JAX renderer's do)."""
    zeros = torch.zeros(org.shape[0], device=org.device)
    ts_s, _, _ = _sphere_ts(scn, org, dirs, zeros)
    lim = (dist - 1e-3)[:, None]
    blocked = (ts_s < lim).any(1)
    if scn["box_centers"].shape[0] > 0:
        blocked = blocked | (_box_ts(scn, org, dirs, zeros)[0] < lim).any(1)
    if scn["cyl_radius"].shape[0] > 0:
        blocked = blocked | (_cyl_ts(scn, org, dirs, zeros)[0] < lim).any(1)
    if scn["tris"].shape[0] > 0:
        blocked = blocked | ops.tri_any(org, dirs, dist, scn["tris"])
    return blocked


# ---------------------------------------------------------------------------
# Shading

def _value_noise(q):
    """Trilinear hash-lattice value noise in [0, 1) for points [N, 3]
    (a sin-dot lattice hash; an ulp of sin moves it by ~3e-3)."""
    qf = torch.floor(q)
    f = q - qf
    f = f * f * (3.0 - 2.0 * f)              # smoothstep fade

    def corner(dx, dy, dz):
        h = torch.sin((qf[:, 0] + dx) * 127.1 + (qf[:, 1] + dy) * 311.7
                      + (qf[:, 2] + dz) * 74.7)
        return torch.remainder((h * 43758.5453).abs(), 1.0)

    n = torch.zeros(q.shape[0], device=q.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                n = n + w * corner(dx, dy, dz)
    return n


def _bilinear_gather(flat_rgb, row, col, h, w, base, wrap_rows):
    """Bilinear lookup into a flattened [*, 3] image at fractional (row,
    col) pixel coords; ``base`` [N] offsets into a stacked image array.
    Columns always wrap; rows wrap or clamp (equirect poles). Indices are
    clamped into the array as XLA's gather clamps them."""
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    fr = (row - r0)[:, None]
    fc = (col - c0)[:, None]
    last = flat_rgb.shape[0] - 1

    def at(ri, ci):
        ri = _to_int32(ri)
        ci = torch.remainder(_to_int32(ci), w)
        ri = (torch.remainder(ri, h) if wrap_rows
              else torch.clamp(ri, 0, h - 1))
        idx = torch.clamp(base + ri * w + ci, 0, last)
        return flat_rgb[idx.long()]

    return (at(r0, c0) * (1 - fr) * (1 - fc)
            + at(r0, c0 + 1) * (1 - fr) * fc
            + at(r0 + 1, c0) * fr * (1 - fc)
            + at(r0 + 1, c0 + 1) * fr * fc)


def _sample_image_stack(images, ids, u, v):
    """Wrap-addressed bilinear sample of per-ray image slots ``ids`` [N]
    (clipped into range) of ``images`` [T, S, S, 3] at texture coords
    ``u, v`` [N] (1.0 = one tile repeat)."""
    t, s = images.shape[0], images.shape[1]
    flat = images.reshape(-1, 3)
    base = torch.clamp(ids, 0, t - 1) * (s * s)
    row = torch.remainder(v, 1.0) * s - 0.5
    col = torch.remainder(u, 1.0) * s - 0.5
    return _bilinear_gather(flat, row, col, s, s, base, wrap_rows=True)


def _sample_equirect(img, d):
    """Equirectangular lookup for directions [N, 3]: u from atan2(z, x), v
    from acos(y); rows clamp at the poles, columns wrap in azimuth."""
    eh, ew = img.shape[0], img.shape[1]
    u = torch.atan2(d[:, 2], d[:, 0]) / (2 * math.pi) + 0.5
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    row = v * eh - 0.5
    col = torch.remainder(u, 1.0) * ew - 0.5
    base = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    return _bilinear_gather(img.reshape(-1, 3), row, col, eh, ew, base,
                            wrap_rows=False)


def _tex_mod(kind, q, phase):
    """Albedo modulation in (0, 1] for texture ``kind`` at scaled points
    ``q`` [N, 3] (3D checker, value noise or stripes)."""
    ch3 = torch.remainder(torch.floor(q[:, 0]) + torch.floor(q[:, 1])
                          + torch.floor(q[:, 2]), 2.0)
    m_checker = 0.55 + 0.45 * ch3
    m_noise = 0.4 + 0.6 * torch.clamp(
        0.65 * _value_noise(q) + 0.35 * _value_noise(q * 2.7 + 13.1),
        0.0, 1.0)
    m_stripes = 0.55 + 0.45 * torch.sin(
        2 * math.pi * (q[:, 0] * 0.8 + q[:, 2] * 0.6) + phase)
    return torch.where(kind == TEX_NOISE, m_noise,
                       torch.where(kind == TEX_STRIPES, m_stripes,
                                   m_checker))


def _frame(normal):
    """Orthonormal (tangent, bitangent) around per-ray vectors [N, 3]."""
    axes = torch.eye(3, device=normal.device)  # made on the device: no copy
    up = torch.where(normal[:, 1:2].abs() < 0.9, axes[1], axes[0])
    tang = _cross(up, normal)
    tang = tang / (_norm(tang)[:, None] + 1e-12)
    bitan = _cross(normal, tang)
    return tang, bitan


def _cosine_sample(u1, u2, normal):
    """Cosine-weighted hemisphere sample around per-ray normals [N, 3] from
    two uniforms [N]; returns the direction and its pdf."""
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    tang, bitan = _frame(normal)
    l0, l1 = r * torch.cos(phi), r * torch.sin(phi)
    l2 = torch.sqrt(torch.clamp_min(1 - u1, 0.0))
    d = l0[:, None] * tang + l1[:, None] * bitan + l2[:, None] * normal
    pdf = torch.clamp_min(l2, 1e-6) / math.pi
    return d, pdf


def _phong_sample(u1, u2, axis, n_exp):
    """Phong-lobe sample around per-ray axes [N, 3] with exponent [N]."""
    cos_a = u1 ** (1.0 / (n_exp + 1.0))
    sin_a = torch.sqrt(torch.clamp_min(1 - cos_a ** 2, 0.0))
    phi = 2 * math.pi * u2
    tang, bitan = _frame(axis)
    return (sin_a[:, None] * torch.cos(phi)[:, None] * tang
            + sin_a[:, None] * torch.sin(phi)[:, None] * bitan
            + cos_a[:, None] * axis)


def _phong_pdf(d, axis, n_exp):
    cos_a = torch.clamp_min(_dot(d, axis), 0.0)
    return (n_exp + 1.0) / (2 * math.pi) * cos_a ** n_exp


def _sphere_dir(gauss, center, radius, p):
    """A direction from ``p`` towards a point of the spherical light, from
    standard normals [N, 3]; returns dir, dist, pdf (solid angle)."""
    u = gauss / (_norm(gauss)[:, None] + 1e-12)
    lp = center[None] + radius * u
    v = lp - p
    dist = _norm(v) + 1e-8
    d = v / dist[:, None]
    # pdf over solid angle of the visible cone (approx: full sphere area)
    area = 4 * math.pi * radius ** 2
    cos_l = _dot(u, -d).abs() + 1e-6
    pdf = (dist ** 2) / (area * cos_l)
    return d, dist, pdf


def _light_pdf_towards(scn, p, d):
    """Solid-angle pdf that :func:`_sphere_dir` would assign to direction
    ``d`` from ``p`` (0 if the ray misses the light sphere), and the hit
    distance (``_INF`` on a miss)."""
    oc = p - scn["light_pos"][None]
    b = _dot(oc, d)
    cc = _dot(oc, oc) - scn["light_radius"] ** 2
    disc = b * b - cc
    t_l = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit_l = (disc > 0) & (t_l > 1e-3)
    lp = p + t_l[:, None] * d
    u = ((lp - scn["light_pos"][None])
         / torch.clamp_min(scn["light_radius"], 1e-8))
    area = 4 * math.pi * scn["light_radius"] ** 2
    cos_l = _dot(u, -d).abs() + 1e-6
    pdf = torch.where(hit_l, (t_l ** 2) / (area * cos_l), 0.0)
    return pdf, torch.where(hit_l, t_l, _INF)


def _sky_radiance(scn, d):
    """Gradient sky + sun + procedural envmap lobes (+ the equirect image)
    for escaping directions [N, 3]."""
    h = torch.clamp(d[:, 1], 0.0, 1.0)[:, None]
    base = scn["sky"][None] * (1 - h) + scn["sky_zenith"][None] * h
    cos_sun = torch.clamp_min(_dot(d, scn["sun_dir"][None]), 0.0)
    sun = scn["sun_color"][None] * (cos_sun[:, None] ** scn["sun_exp"])
    cos_l = torch.clamp_min(d @ scn["env_dirs"].T, 0.0)   # [N, M]
    lobes = (cos_l ** scn["env_exps"][None]) @ scn["env_colors"]
    out = base + sun + lobes
    if scn["env_image"].shape[0] > 0:
        out = out + _sample_equirect(scn["env_image"],
                                     d) * scn["env_image_scale"]
    return out


def _ipow(x, y):
    """``x ** y`` for a positive int ``y`` by repeated squaring, as
    ``lax.integer_pow`` computes ``jnp`` powers with an integer exponent
    (torch's ``x ** 5`` calls ``pow`` and rounds differently)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _power_w(pdf_a, pdf_b):
    """Power heuristic (beta=2), the PBRT EstimateDirect weighting."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-12)


# ---------------------------------------------------------------------------
# Passes

def _trace(scn, keys, ts, block_xs, block_ys, image_width, image_height):
    """Trace ``B`` passes as one wavefront of ``B * ts * ts`` rays, pass
    ``b`` from ``keys[b]`` over the tile at ``(block_xs[b], block_ys[b])``.

    Returns the records of ``render_pass`` with ``B * ts * ts`` rows, pass
    by pass."""
    dev = scn["centers"].device
    n = ts * ts
    nb = len(keys)
    rays = nb * n
    uni_keys, nrm_keys = pass_keys(np.asarray(keys, np.uint32))
    uni = ops.random_uniform(
        _upload(uni_keys.reshape(-1, 2).view(np.int32), dev),
        n).view(nb, _UNIFORM_DRAWS, n)
    gauss = ops.random_uniform(
        _upload(nrm_keys.reshape(-1, 2).view(np.int32), dev), 3 * n,
        prng.NORMAL_LO, 1.0)
    gauss = (torch.erfinv(gauss) * math.sqrt(2)).view(nb, MAX_DEPTH, n, 3)

    def draw(i):
        return uni[:, i].reshape(rays)

    ys, xs = torch.meshgrid(torch.arange(ts, device=dev),
                            torch.arange(ts, device=dev), indexing="ij")
    bx = _upload(np.asarray(block_xs, np.float32), dev)
    by = _upload(np.asarray(block_ys, np.float32), dev)
    px = (xs.reshape(1, -1) + bx[:, None]).to(torch.float32).reshape(rays)
    py = (ys.reshape(1, -1) + by[:, None]).to(torch.float32).reshape(rays)

    dx, dy = draw(0), draw(1)
    r_lens = torch.sqrt(draw(2))
    phi_lens = draw(3) * 2 * math.pi
    lens_u = r_lens * torch.cos(phi_lens) * scn["aperture"]
    lens_v = r_lens * torch.sin(phi_lens) * scn["aperture"]
    t_time = draw(4)

    tan_half = torch.tan(scn["fov"] * (math.pi / 180) / 2)
    u = ((px + dx) / image_width * 2 - 1) * tan_half * (
        image_width / image_height)
    v = -((py + dy) / image_height * 2 - 1) * tan_half
    dirs = torch.stack([u, v, torch.ones(rays, device=dev)], -1)
    dirs = dirs / _norm(dirs)[:, None]
    org = scn["cam_pos"][None].expand(rays, 3)
    if scn["lens"]:
        focus_t = scn["focus_distance"] / dirs[:, 2]
        focal_p = dirs * focus_t[:, None]
        o = torch.stack([lens_u, lens_v, torch.zeros(rays, device=dev)], -1)
        d = focal_p - o
        org, dirs = o + scn["cam_pos"][None], d / _norm(d)[:, None]
    org = org.contiguous()

    zeros = torch.zeros(rays, device=dev)
    zeros3 = torch.zeros(rays, 3, device=dev)
    beta = torch.ones(rays, 3, device=dev)
    alive = torch.ones(rays, dtype=torch.bool, device=dev)
    specular_chain = torch.zeros(rays, dtype=torch.bool, device=dev)
    L_diffuse, L_specular = zeros3, zeros3
    f = {"normal_first": zeros3, "normal": zeros3, "depth_first": zeros,
         "depth": zeros, "albedo_first": zeros3, "albedo": zeros3,
         "visibility": zeros, "has_hit": zeros,
         "got_first": torch.zeros(rays, dtype=torch.bool, device=dev),
         "got_diffuse": torch.zeros(rays, dtype=torch.bool, device=dev),
         "dist_so_far": zeros}
    emit = scn["light_emission"][None]
    p_recs, ld_recs, bt_recs = [], [], []

    for d_idx in range(MAX_DEPTH):
        base = _CAMERA_DRAWS + d_idx * _VERTEX_DRAWS
        rec = _intersect(scn, org, dirs, t_time)
        hit = rec["hit"] & alive
        mat = rec["mat"]
        is_mirror = mat == MAT_MIRROR
        is_glass = mat == MAT_GLASS
        is_delta = is_mirror | is_glass
        is_metal = mat == MAT_METAL
        is_plastic = mat == MAT_PLASTIC
        is_glossy = is_metal | is_plastic
        to_spec = specular_chain & (d_idx > 0)

        # Environment contribution for escaping rays (sky is only reached
        # by BSDF samples, so no MIS weight applies).
        escaped = alive & ~rec["hit"]
        env = beta * _sky_radiance(scn, dirs)
        L_diffuse = L_diffuse + torch.where(
            (escaped & ~to_spec)[:, None], env, 0.0)
        L_specular = L_specular + torch.where(
            (escaped & to_spec)[:, None], env, 0.0)

        # --- next-event estimation to the spherical light ----------------
        ldir, ldist, lpdf = _sphere_dir(
            gauss[:, d_idx].reshape(rays, 3), scn["light_pos"],
            scn["light_radius"], rec["p"])
        shadowed = _occluded(scn, (rec["p"] + 1e-3 * ldir).contiguous(),
                             ldir.contiguous(), ldist.contiguous())
        cos_s = torch.clamp_min(_dot(rec["normal"], ldir), 0.0)

        # BSDF value and pdf in the light direction (for MIS).
        d_mirr = dirs - 2 * _dot(dirs, rec["normal"])[:, None] * rec["normal"]
        n_exp = 2.0 / torch.clamp(rec["roughness"], 0.05, 1.0) ** 2
        pdf_cos_l = cos_s / math.pi
        pdf_ph_l = _phong_pdf(ldir, d_mirr, n_exp)
        f_diff = rec["albedo"] / math.pi
        f_phong = (n_exp + 2.0) / (2 * math.pi) * torch.clamp_min(
            _dot(ldir, d_mirr), 0.0) ** n_exp
        f_l = torch.where(
            is_metal[:, None], rec["albedo"] * f_phong[:, None],
            torch.where(is_plastic[:, None],
                        f_diff * _PLASTIC_DIFFUSE_P
                        + (1 - _PLASTIC_DIFFUSE_P) * f_phong[:, None],
                        torch.where(is_delta[:, None], 0.0, f_diff)))
        bpdf_l = torch.where(
            is_metal, pdf_ph_l,
            torch.where(is_plastic,
                        _PLASTIC_DIFFUSE_P * pdf_cos_l
                        + (1 - _PLASTIC_DIFFUSE_P) * pdf_ph_l,
                        torch.where(is_delta, 0.0, pdf_cos_l)))
        w_nee = _power_w(lpdf, bpdf_l)

        vis = (~shadowed) & hit & ~is_delta
        contrib = (beta * f_l * emit
                   * (w_nee * cos_s / torch.clamp_min(lpdf, 1e-6))[:, None])
        contrib = torch.where(vis[:, None], contrib, 0.0)
        L_diffuse = L_diffuse + torch.where(to_spec[:, None], 0.0, contrib)
        L_specular = L_specular + torch.where(to_spec[:, None], contrib, 0.0)

        # --- record first-geometric / first-diffuse bounce features ------
        f = dict(f)
        dist_here = f["dist_so_far"] + rec["t"]
        new_first = hit & ~f["got_first"]
        f["normal_first"] = torch.where(new_first[:, None], rec["normal"],
                                        f["normal_first"])
        f["depth_first"] = torch.where(new_first, dist_here,
                                       f["depth_first"])
        f["albedo_first"] = torch.where(new_first[:, None], rec["albedo"],
                                        f["albedo_first"])
        f["has_hit"] = torch.where(new_first, 1.0, f["has_hit"])
        f["got_first"] = f["got_first"] | hit

        new_diffuse = hit & ~is_delta & ~f["got_diffuse"]
        f["normal"] = torch.where(new_diffuse[:, None], rec["normal"],
                                  f["normal"])
        f["depth"] = torch.where(new_diffuse, dist_here, f["depth"])
        f["albedo"] = torch.where(new_diffuse[:, None], rec["albedo"],
                                  f["albedo"])
        f["visibility"] = torch.where(
            new_diffuse, torch.where(shadowed, 0.0, 1.0), f["visibility"])
        f["got_diffuse"] = f["got_diffuse"] | new_diffuse
        f["dist_so_far"] = torch.where(hit, dist_here, f["dist_so_far"])

        # --- sample the BSDF for the next segment -------------------------
        d_diff, _ = _cosine_sample(draw(base), draw(base + 1),
                                   rec["normal"])
        d_ph = _phong_sample(draw(base + 2), draw(base + 3), d_mirr, n_exp)
        # Glossy samples below the horizon carry zero BRDF: fall back to the
        # diffuse lobe so the path continues (energy handled by f/pdf).
        ph_below = _dot(d_ph, rec["normal"]) <= 0
        u_f = draw(base + 4)

        # Glass: Fresnel-weighted reflect/refract (Schlick).
        cos_i = torch.clamp_min(-_dot(dirs, rec["normal"]), 1e-6)
        eta = torch.where(rec["inside"], scn["glass_ior"],
                          1.0 / scn["glass_ior"])
        sin2_t = eta ** 2 * (1.0 - cos_i ** 2)
        tir = sin2_t > 1.0
        r0 = ((1 - scn["glass_ior"]) / (1 + scn["glass_ior"])) ** 2
        fres = r0 + (1 - r0) * _ipow(1 - cos_i, 5)
        reflect_glass = tir | (u_f < fres)
        d_refr = (eta[:, None] * dirs
                  + (eta * cos_i - torch.sqrt(torch.clamp_min(1 - sin2_t,
                                                              0.0))
                     )[:, None] * rec["normal"])
        d_refr = d_refr / (_norm(d_refr)[:, None] + 1e-12)
        d_glass = torch.where(reflect_glass[:, None], d_mirr, d_refr)

        # Plastic: pick base diffuse lobe vs glossy coat.
        pl_diffuse = u_f < _PLASTIC_DIFFUSE_P
        d_plastic = torch.where((pl_diffuse | ph_below)[:, None], d_diff,
                                d_ph)

        next_dir = torch.where(
            is_mirror[:, None], d_mirr,
            torch.where(is_glass[:, None], d_glass,
                        torch.where(is_metal[:, None],
                                    torch.where(ph_below[:, None], d_diff,
                                                d_ph),
                                    torch.where(is_plastic[:, None],
                                                d_plastic, d_diff))))

        # pdf of the sampled direction (0 marks delta lobes).
        cos_o = torch.clamp_min(_dot(next_dir, rec["normal"]), 0.0)
        pdf_cos_o = cos_o / math.pi
        pdf_ph_o = _phong_pdf(next_dir, d_mirr, n_exp)
        bsdf_pdf = torch.where(
            is_metal, torch.where(ph_below, pdf_cos_o, pdf_ph_o),
            torch.where(is_plastic,
                        _PLASTIC_DIFFUSE_P * pdf_cos_o
                        + (1 - _PLASTIC_DIFFUSE_P) * pdf_ph_o,
                        torch.where(is_delta, 0.0, pdf_cos_o)))

        # BSDF value along the sampled direction -> throughput update.
        f_ph_o = (n_exp + 2.0) / (2 * math.pi) * torch.clamp_min(
            _dot(next_dir, d_mirr), 0.0) ** n_exp
        f_o = torch.where(
            is_metal[:, None], rec["albedo"] * f_ph_o[:, None],
            torch.where(is_plastic[:, None],
                        rec["albedo"] / math.pi * _PLASTIC_DIFFUSE_P
                        + (1 - _PLASTIC_DIFFUSE_P) * f_ph_o[:, None],
                        rec["albedo"] / math.pi))
        thr = f_o * (cos_o / torch.clamp_min(bsdf_pdf, 1e-6))[:, None]
        thr = torch.where(is_delta[:, None],
                          torch.where(is_mirror[:, None], rec["albedo"], 1.0),
                          torch.clamp(thr, 0.0, 4.0))
        beta = torch.where(hit[:, None], beta * thr, beta)

        # --- BSDF-sampled light hit (the other MIS branch) ---------------
        lpdf_o, t_l = _light_pdf_towards(scn, rec["p"], next_dir)
        blocked = _occluded(scn, (rec["p"] + 1e-3 * next_dir).contiguous(),
                            next_dir.contiguous(),
                            torch.clamp_max(t_l, _INF))
        hits_light = hit & (t_l < _INF) & ~blocked
        w_bsdf = torch.where(is_delta, 1.0, _power_w(bsdf_pdf, lpdf_o))
        l_contrib = beta * emit * w_bsdf[:, None]
        l_contrib = torch.where(hits_light[:, None], l_contrib, 0.0)
        next_spec = is_delta if d_idx == 0 else specular_chain & is_delta
        to_spec_next = next_spec & hit
        L_diffuse = L_diffuse + torch.where(to_spec_next[:, None], 0.0,
                                            l_contrib)
        L_specular = L_specular + torch.where(to_spec_next[:, None],
                                              l_contrib, 0.0)

        # --- per-vertex records (p, ld, bt) -------------------------------
        # The four MIS pdfs of the reference's LightQueryRecord.
        theta = torch.acos(torch.clamp(ldir[:, 1], -1, 1))
        phi = torch.atan2(ldir[:, 2], ldir[:, 0])
        ld_recs.append(torch.where(hit[:, None],
                                   torch.stack([theta, phi], -1), 0.0))
        bsdf_pdf_rec = torch.where(is_delta, 1.0, bsdf_pdf)  # delta -> 1
        p_recs.append(torch.stack([
            torch.where(hit, lpdf, 0.0),
            torch.where(hit, bpdf_l, 0.0),
            torch.where(hit, bsdf_pdf_rec, 0.0),
            torch.where(hit, lpdf_o, 0.0)], -1))
        refracted = is_glass & ~reflect_glass
        bt_recs.append(torch.where(
            hit,
            torch.where(refracted, BT_TRANSMISSION | BT_SPECULAR,
                        torch.where(is_mirror | is_glass,
                                    BT_REFLECTION | BT_SPECULAR,
                                    torch.where(is_glossy,
                                                BT_REFLECTION | BT_GLOSSY,
                                                BT_REFLECTION | BT_DIFFUSE))),
            0).to(torch.int16))

        org = torch.where(hit[:, None], rec["p"] + 1e-3 * next_dir,
                          org).contiguous()
        dirs = torch.where(hit[:, None], next_dir, dirs).contiguous()
        alive = hit
        specular_chain = next_spec

    # 1 / (10 * scene_radius): SampleRecord::normalize_distances.
    inv_norm = 1.0 / (10.0 * scn["scene_radius"])
    return {
        "dx": dx, "dy": dy,
        "lens_u": lens_u * inv_norm, "lens_v": lens_v * inv_norm,
        "t": t_time,
        "diffuse": L_diffuse, "specular": L_specular,
        "normal_first": f["normal_first"], "normal": f["normal"],
        "depth_first": f["depth_first"] * inv_norm,
        "depth": f["depth"] * inv_norm,
        "visibility": f["visibility"], "has_hit": f["has_hit"],
        "albedo_first": f["albedo_first"], "albedo": f["albedo"],
        "p": torch.stack(p_recs, 1).reshape(rays, -1),
        "ld": torch.stack(ld_recs, 1).reshape(rays, -1),
        "bt": torch.stack(bt_recs, 1),
    }


@contextlib.contextmanager
def _float32_matmuls():
    """While a tile renders: no autograd, and full float32 matrix products
    on the card (no TF32), whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def render_pass(scn, key, ts, block_x, block_y, image_width, image_height):
    """Trace one sample per pixel of a tile; returns per-pixel records.

    ``scn`` is :func:`prepare_scene`'s dict (its device is where the pass
    runs), ``key`` a ``uint32 [2]`` key (:mod:`sbmc_tpu_torch.render.prng`).
    Returns a dict with "diffuse", "specular", the g-buffer planes, "p"
    ``[n, 4*D]``, "ld" ``[n, 2*D]``, "bt" ``[n, D]`` and the sample
    coordinates (``n = ts*ts`` rows), as the JAX renderer's ``render_pass``.
    """
    with _float32_matmuls():
        return _trace(scn, np.asarray(key, np.uint32)[None], ts, [block_x],
                      [block_y], image_width, image_height)


def _pix_features(rec):
    return torch.cat([
        rec["diffuse"], rec["specular"], rec["albedo_first"],
        rec["normal_first"], rec["depth_first"][:, None],
        rec["visibility"][:, None], rec["has_hit"][:, None]], -1)


def _sample_features(rec):
    return torch.cat([
        rec["dx"][:, None], rec["dy"][:, None], rec["lens_u"][:, None],
        rec["lens_v"][:, None], rec["t"][:, None],
        rec["diffuse"], rec["specular"], rec["normal_first"],
        rec["normal"], rec["depth_first"][:, None],
        rec["depth"][:, None], rec["visibility"][:, None],
        rec["has_hit"][:, None], rec["albedo_first"], rec["albedo"]], -1)


def _tile_passes(scn, tile_keys, block_xs, block_ys, ts, image_width,
                 image_height, spp, gt_spp):
    """All passes of a batch of tiles (the JAX renderer's ``_tile_passes``,
    vmapped over tiles): Welford statistics over each tile's ``gt_spp``
    ground-truth passes, in pass order, then its ``spp`` recorded passes.
    Passes are traced up to ``_WAVEFRONT_RAYS`` rays at a time, every pass
    with its own key.

    Returns per tile ``(mean [n, 15], var [n, 15], feats [spp, n, 27],
    p [spp, n, 4D], ld [spp, n, 2D], bt [spp, n, D])`` as device tensors."""
    dev = scn["centers"].device
    n = ts * ts
    n_tiles = len(tile_keys)
    per_batch = max(1, _WAVEFRONT_RAYS // (n * n_tiles))
    recorded, truth = zip(*(_tile_keys(k, spp, gt_spp) for k in tile_keys))

    def batches(keys_of_tile, count):
        for j0 in range(0, count, per_batch):
            j1 = min(count, j0 + per_batch)
            keys = [keys_of_tile[i][j] for i in range(n_tiles)
                    for j in range(j0, j1)]
            bxs = [block_xs[i] for i in range(n_tiles) for _ in range(j0, j1)]
            bys = [block_ys[i] for i in range(n_tiles) for _ in range(j0, j1)]
            yield j1 - j0, _trace(scn, keys, ts, bxs, bys, image_width,
                                  image_height)

    mean = [torch.zeros(n, 15, device=dev) for _ in range(n_tiles)]
    m2 = [torch.zeros(n, 15, device=dev) for _ in range(n_tiles)]
    cnt = 0.0  # a float32 count in JAX: exact up to 2**24 passes
    for nb, rec in batches(truth, gt_spp):
        x = _pix_features(rec).view(n_tiles, nb, n, 15)
        for j in range(nb):
            cnt += 1.0
            for i in range(n_tiles):
                delta = x[i, j] - mean[i]
                mean[i] = mean[i] + delta / cnt
                m2[i] = m2[i] + delta * (x[i, j] - mean[i])
    var = [m / cnt for m in m2]

    out = [[], [], [], []]  # features, p, ld, bt
    for nb, rec in batches(recorded, spp):
        parts = (_sample_features(rec), rec["p"], rec["ld"], rec["bt"])
        for k, part in enumerate(parts):
            out[k].append(part.view(n_tiles, nb, n, -1))
    recs = [torch.cat(parts, 1) for parts in out]
    return [(mean[i], var[i]) + tuple(r[i] for r in recs)
            for i in range(n_tiles)]


def _render(scene, keys, coords, ts, spp, gt_spp, image_width, image_height,
            kpcn_mode, device, stats):
    """Render the tiles ``coords`` ((block_x, block_y) each, keys[i] for
    tile i) in one batch; adds the device span to ``stats["device"]``."""
    scn = prepare_scene(scene, device)
    cuda = device.type == "cuda"
    with _float32_matmuls():
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        tiles = _tile_passes(scn, keys, [bx for bx, _ in coords],
                             [by for _, by in coords], ts, image_width,
                             image_height, spp, gt_spp)
        if cuda:
            end.record()
        host = [tuple(a.cpu().numpy() for a in t) for t in tiles]
    if cuda and stats is not None:
        stats["device"] = stats.get("device", 0.0) + start.elapsed_time(
            end) / 1e3
    return [_tile_from_arrays(scene, ts, spp, gt_spp, int(bx), int(by),
                              image_width, image_height, kpcn_mode, *arrays)
            for (bx, by), arrays in zip(coords, host)]


def render_tile_wavefront(scene, key, ts=128, spp=8, gt_spp=64, block_x=0,
                          block_y=0, image_width=None, image_height=None,
                          kpcn_mode=False, device="cuda", stats=None):
    """Render one tile into a :class:`bin_format.Tile`.

    ``key`` is a ``uint32 [2]`` key (``prng.PRNGKey(seed)``). Runs on
    ``device`` (the card unless the caller asks for the CPU); ``stats``, a
    dict, gets the device time in ``"device"`` (seconds between CUDA events
    around the tile's work). ``kpcn_mode=True`` records with the
    ``PathKPCNIntegrator`` conventions (unnormalized distances and
    probabilities)."""
    device = resolve_device(device)
    return _render(scene, np.asarray(key, np.uint32)[None],
                   [(block_x, block_y)],
                   ts, spp, gt_spp, image_width or ts, image_height or ts,
                   kpcn_mode, device, stats)[0]


def iter_tiles_wavefront(scene, base_key, coords, ts=128, spp=8,
                         gt_spp=64, image_width=None, image_height=None,
                         kpcn_mode=False, tile_batch=1, device="cuda",
                         stats=None):
    """Render several tiles of one scene, ``tile_batch`` tiles per traced
    wavefront (the env knob ``SBMC_TILE_BATCH`` overrides it); yields each
    wavefront's ``(coords, tiles)`` as it is done.

    ``coords`` is a list of ``(tile_index, block_x, block_y)``; each tile's
    key is ``fold_in(base_key, tile_index)``, so batched and serial tiles
    match."""
    device = resolve_device(device)
    image_width = image_width or ts
    image_height = image_height or ts
    tile_batch = max(1, int(os.environ.get("SBMC_TILE_BATCH", tile_batch)))
    for c0 in range(0, len(coords), tile_batch):
        chunk = coords[c0:c0 + tile_batch]
        keys = [prng.fold_in(base_key, idx) for idx, _, _ in chunk]
        yield chunk, _render(scene, keys, [(bx, by) for _, bx, by in chunk],
                             ts, spp, gt_spp, image_width, image_height,
                             kpcn_mode, device, stats)


def render_tiles_wavefront(*args, **kwargs):
    """:func:`iter_tiles_wavefront`'s tiles in ``coords`` order."""
    return [tile for _, tiles in iter_tiles_wavefront(*args, **kwargs)
            for tile in tiles]


def _tile_from_arrays(scene, ts, spp, gt_spp, block_x, block_y,
                      image_width, image_height, kpcn_mode,
                      mean, var, feats, p, ld, bt):
    """Host post-processing of one tile's arrays into a
    :class:`bin_format.Tile` (numpy, as in the JAX package)."""

    def clean(x):
        # The reference writer zeroes NaN/infinite radiance before saving;
        # rare degenerate paths can emit non-finite records here too.
        return np.nan_to_num(np.asarray(x), nan=0.0, posinf=0.0,
                             neginf=0.0)

    def img(x):  # [N, C] -> [C, ts, ts]
        return clean(x).reshape(ts, ts, -1).transpose(2, 0, 1)

    def simg(x):  # [spp, N, C] -> [spp, C, ts, ts]
        return clean(x).reshape(spp, ts, ts, -1).transpose(0, 3, 1, 2)

    # Probability normalization like the reference writer: log(p + 1e-8) /
    # 30, skipped in kpcn mode.
    p_n = clean(p)
    if not kpcn_mode:
        p_n = np.log(np.minimum(p_n, 1e12) + 1e-8) / 30.0

    inv_norm = 1.0 / (10.0 * scene.scene_radius)
    feats = simg(feats).astype(np.float32)
    pix = np.concatenate([img(mean), img(np.maximum(var, 0))], 0
                         ).astype(np.float32)
    if kpcn_mode:
        # The tracer normalizes distance-like features inline; undo it so
        # the records carry raw distances (PathKPCNIntegrator convention).
        denorm = np.float32(10.0 * scene.scene_radius)
        for name in ("lens_u", "lens_v", "depth_first", "depth"):
            feats[:, SAMPLE_FEATURE_IDX[name]] *= denorm
        d_pix = PIXEL_DEPTH_IDX
        pix[d_pix] *= denorm                       # mean depth channel
        pix[d_pix + bin_format.PIXEL_FEATURES // 2] *= denorm * denorm
    return bin_format.Tile(
        tile_size=ts, image_width=image_width, image_height=image_height,
        sample_count=spp, gt_sample_count=gt_spp,
        focus_distance=(scene.focus_distance * (1.0 if kpcn_mode
                                                else inv_norm)
                        if scene.aperture > 0 else 0.0),
        aperture_radius=scene.aperture * (1.0 if kpcn_mode else inv_norm),
        fov=scene.fov / 100.0,
        scene_radius=scene.scene_radius,
        block_x=block_x, block_y=block_y,
        pixel_data=pix,
        features=feats,
        p=simg(p_n).astype(np.float32),
        ld=simg(ld).astype(np.float32),
        bt=simg(bt).astype(np.int16),
    )


def generate_wavefront_dataset(outdir, n_scenes=2, ts=128, tiles_per_side=1,
                               spp=8, gt_spp=64, seed=0, start_index=0,
                               key=None, kpcn_mode=False, obj_pool=None,
                               tiles_y=None, tex_pool=None, env_pool=None,
                               device="cuda", stats=None, stride=1):
    """Write a folder-of-scenes dataset rendered by the wavefront tracer:
    ``scene_%05d/tile_%04d_%04d.bin``, scene ``i`` drawn from
    ``RandomState(seed + i)`` and traced from ``PRNGKey(seed + i)`` (or
    ``key``), as the JAX package writes it. The scenes are ``i =
    start_index + s * stride`` for ``s < n_scenes``: a worker of several
    renders every ``stride``-th scene (the JAX package renders ``start_index
    + s``, the same at ``stride`` 1).

    ``tiles_per_side`` sets the tile-grid width, ``tiles_y`` (default:
    square) its height. Prints a progress line every 10 scenes. ``stats``,
    a dict, gets the seconds spent in each phase: "sample" (drawing
    scenes), "compile" (building the kernels at first use), "device"
    (between CUDA events around each tile batch's work), "host" (the rest
    of rendering: tracing calls not hidden behind the device, fetches,
    post-processing), "write" (the ``.bin`` files) and "total"."""
    device = resolve_device(device)
    t_start = time.time()
    tiles_x = tiles_per_side
    if tiles_y is None:
        tiles_y = tiles_per_side
    acc = {"sample": 0.0, "device": 0.0, "compile": 0.0, "host": 0.0,
           "write": 0.0}
    if device.type == "cuda":
        from sbmc_tpu_torch.ops import _build
        t0 = time.time()
        _build.load_cuda()
        acc["compile"] += time.time() - t0
    for s in range(n_scenes):
        idx = start_index + s * stride
        t0 = time.time()
        rng = np.random.RandomState(seed + idx)
        scene = random_tracer_scene(rng, obj_pool=obj_pool,
                                    tex_pool=tex_pool, env_pool=env_pool)
        acc["sample"] += time.time() - t0
        sdir = os.path.join(outdir, "scene_%05d" % idx)
        os.makedirs(sdir, exist_ok=True)
        if s and s % 10 == 0:
            done = time.time() - t_start
            print("wavefront datagen: %d/%d scenes (%.1f s/scene; "
                  "device %.0f%% compile %.0f%% host %.0f%% write %.0f%% "
                  "sample %.0f%%)"
                  % (s, n_scenes, done / s,
                     *(100.0 * acc[k] / max(done, 1e-9)
                       for k in ("device", "compile", "host", "write",
                                 "sample"))), flush=True)
        w, h = ts * tiles_x, ts * tiles_y
        base_key = prng.PRNGKey(seed + idx) if key is None else key
        coords = [(ty * tiles_x + tx, tx * ts, ty * ts)
                  for ty in range(tiles_y) for tx in range(tiles_x)]
        phase = {}
        batches = iter_tiles_wavefront(
            scene, base_key, coords, ts=ts, spp=spp, gt_spp=gt_spp,
            image_width=w, image_height=h, kpcn_mode=kpcn_mode,
            device=device, stats=phase)
        while True:
            t0, dev0 = time.time(), phase.get("device", 0.0)
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.time()
            dev = phase.get("device", 0.0) - dev0
            acc["device"] += dev
            acc["host"] += (t1 - t0) - dev
            for (_, bx, by), tile in zip(*batch):
                bin_format.write_tile(
                    os.path.join(sdir, "tile_%04d_%04d.bin"
                                 % (by // ts, bx // ts)), tile)
            acc["write"] += time.time() - t1
    acc["total"] = time.time() - t_start
    if stats is not None:
        stats.update(acc)
    return outdir
