"""Self-contained synthetic sample-data renderer (a copy of
``sbmc_tpu/data/synthetic.py``; the same seed writes the same bytes).

Generates procedural sphere/plane scenes and renders per-sample feature
records directly in numpy — a stand-in for the reference's patched-PBRT
data-generation path (pbrt_patches/sbmc_pbrt.diff) for environments without
the external renderer. It produces the exact v20190401 ``.bin`` layout
(pixel mean/variance statistics plus per-sample records: coordinates,
diffuse/specular radiance, two-bounce g-buffer, path probabilities, light
directions, bounce-type flags) so the full generate -> train -> denoise
pipeline runs end to end, and is the source of bench/test fixtures.

The renderer is a one-bounce direct-lighting ray tracer with:
- subpixel jitter (dx, dy), lens jitter (defocus blur), and a time
  dimension with linear sphere motion (motion blur),
- a point light with jittered soft shadows (visibility),
- diffuse albedo + Blinn-Phong-style specular split,
- Monte-Carlo noise from the jittered sampling itself.
"""

import dataclasses

import numpy as np

from sbmc_tpu_torch.data import bin_format

__all__ = ["SphereScene", "random_scene", "render_tile", "generate_dataset"]


@dataclasses.dataclass
class SphereScene:
    centers: np.ndarray     # [k, 3]
    radii: np.ndarray       # [k]
    albedos: np.ndarray     # [k, 3]
    speculars: np.ndarray   # [k]
    motion: np.ndarray      # [k, 3] per-sphere velocity
    light_pos: np.ndarray   # [3]
    light_rgb: np.ndarray   # [3]
    light_radius: float
    ground_albedo: np.ndarray  # [3]
    sky_rgb: np.ndarray     # [3]
    fov: float
    aperture: float
    focus_distance: float


def random_scene(rng, n_spheres=6):
    centers = np.stack([
        rng.uniform(-3, 3, n_spheres),
        rng.uniform(0.3, 2.5, n_spheres),
        rng.uniform(3.0, 9.0, n_spheres)], axis=1)
    do_motion = rng.rand(n_spheres) < 0.3
    motion = rng.normal(0, 0.15, (n_spheres, 3)) * do_motion[:, None]
    aperture = float(np.exp(rng.uniform(np.log(1e-3), np.log(0.05)))) \
        if rng.rand() < 0.5 else 0.0
    return SphereScene(
        centers=centers,
        radii=rng.uniform(0.3, 1.0, n_spheres),
        albedos=rng.uniform(0.1, 0.95, (n_spheres, 3)),
        speculars=rng.uniform(0, 0.6, n_spheres),
        motion=motion,
        light_pos=np.array([rng.uniform(-4, 4), rng.uniform(4, 8),
                            rng.uniform(0, 6)]),
        light_rgb=rng.uniform(8, 25, 3),
        light_radius=rng.uniform(0.1, 0.8),
        ground_albedo=rng.uniform(0.2, 0.8, 3),
        sky_rgb=rng.uniform(0.05, 0.4, 3),
        fov=float(rng.uniform(25, 60)),
        aperture=aperture,
        focus_distance=float(rng.uniform(3, 8)),
    )


def _intersect(scene, origins, dirs, t):
    """Nearest sphere-or-ground hit for ray bundles.

    Args:
      origins, dirs: ``[n, 3]``.
      t: ``[n]`` sample times (moves the spheres).

    Returns:
      dict of hit attributes, all ``[n, ...]``.
    """
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    hit_id = np.full(n, -1)  # -1 none, -2 ground, >=0 sphere index

    # Ground plane y=0.
    dy = dirs[:, 1]
    tg = np.where(np.abs(dy) > 1e-8, -origins[:, 1] / dy, np.inf)
    ok = tg > 1e-4
    best_t = np.where(ok, tg, best_t)
    hit_id = np.where(ok, -2, hit_id)

    for i in range(len(scene.radii)):
        c = scene.centers[i][None] + t[:, None] * scene.motion[i][None]
        oc = origins - c
        b = np.sum(oc * dirs, axis=1)
        cc = np.sum(oc * oc, axis=1) - scene.radii[i] ** 2
        disc = b * b - cc
        ts = -b - np.sqrt(np.maximum(disc, 0))
        ok = (disc > 0) & (ts > 1e-4) & (ts < best_t)
        best_t = np.where(ok, ts, best_t)
        hit_id = np.where(ok, i, hit_id)

    p = origins + best_t[:, None] * dirs
    normal = np.zeros_like(p)
    albedo = np.tile(scene.sky_rgb[None], (n, 1))
    specular_w = np.zeros(n)

    ground = hit_id == -2
    normal[ground] = [0, 1, 0]
    # Checker albedo on the ground for spatial detail.
    pg = np.where(np.isfinite(p), p, 0.0)
    checker = ((np.floor(pg[:, 0]) + np.floor(pg[:, 2])) % 2)[ground]
    albedo[ground] = scene.ground_albedo[None] * (0.5 + 0.5 *
                                                  checker[:, None])
    for i in range(len(scene.radii)):
        m = hit_id == i
        if not m.any():
            continue
        c = scene.centers[i][None] + t[m, None] * scene.motion[i][None]
        normal[m] = (p[m] - c) / scene.radii[i]
        albedo[m] = scene.albedos[i][None]
        specular_w[m] = scene.speculars[i]

    return {"t": best_t, "id": hit_id, "p": p, "normal": normal,
            "albedo": albedo, "specular_w": specular_w,
            "hit": hit_id != -1}


def _shade(scene, rec, dirs, rng):
    """Direct lighting with jittered soft shadows; returns per-ray diffuse
    and specular radiance, visibility, and the light direction."""
    n = rec["p"].shape[0]
    lpos = scene.light_pos[None] + rng.normal(
        0, scene.light_radius / 2, (n, 3))
    lvec = lpos - rec["p"]
    ldist = np.linalg.norm(lvec, axis=1) + 1e-8
    ldir = lvec / ldist[:, None]

    # Shadow ray.
    srec = _intersect(scene, rec["p"] + 1e-3 * ldir, ldir,
                      np.zeros(n))
    # Only spheres occlude (hit points sit on or above the ground plane).
    visible = (~(srec["id"] >= 0)) | (srec["t"] > ldist)

    ndotl = np.maximum(np.sum(rec["normal"] * ldir, axis=1), 0)
    falloff = 1.0 / (ldist ** 2)
    irradiance = (scene.light_rgb[None] * (ndotl * falloff *
                                           visible)[:, None])
    diffuse = rec["albedo"] * irradiance / np.pi
    # sky/ambient goes in the diffuse slot too
    diffuse = diffuse + rec["albedo"] * scene.sky_rgb[None] * 0.3

    half = ldir - dirs
    half = half / (np.linalg.norm(half, axis=1, keepdims=True) + 1e-8)
    ndoth = np.maximum(np.sum(rec["normal"] * half, axis=1), 0)
    specular = (rec["specular_w"] * ndoth ** 32)[:, None] * irradiance

    miss = ~rec["hit"]
    diffuse[miss] = scene.sky_rgb[None]
    specular[miss] = 0

    return diffuse, specular, visible.astype(np.float32), ldir


def render_tile(scene, rng, ts=128, spp=8, gt_spp=64, block_x=0, block_y=0,
                image_width=None, image_height=None):
    """Render one tile of a scene to a :class:`bin_format.Tile`."""
    image_width = image_width or ts
    image_height = image_height or ts
    pd = bin_format.PATH_DEPTH
    scene_radius = 12.0

    ys, xs = np.meshgrid(np.arange(ts), np.arange(ts), indexing="ij")
    px = (xs + block_x).ravel().astype(np.float64)
    py = (ys + block_y).ravel().astype(np.float64)
    n = ts * ts
    tan_half = np.tan(np.deg2rad(scene.fov) / 2)

    def sample_pass(count, record):
        feats = np.zeros((count, 27, ts, ts), np.float32) if record else None
        acc = np.zeros((15, ts, ts), np.float64)
        acc2 = np.zeros((15, ts, ts), np.float64)
        for s in range(count):
            dx = rng.rand(n)
            dy = rng.rand(n)
            # concentric-ish lens sampling scaled by aperture
            r = np.sqrt(rng.rand(n))
            phi = rng.rand(n) * 2 * np.pi
            lens_u = r * np.cos(phi) * scene.aperture
            lens_v = r * np.sin(phi) * scene.aperture
            t = rng.rand(n)

            # Camera rays (pinhole + thin lens).
            u = ((px + dx) / image_width * 2 - 1) * tan_half * \
                (image_width / image_height)
            v = -((py + dy) / image_height * 2 - 1) * tan_half
            dirs = np.stack([u, v, np.ones(n)], 1)
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            origins = np.zeros((n, 3))
            if scene.aperture > 0:
                focus_t = scene.focus_distance / dirs[:, 2]
                focal_p = dirs * focus_t[:, None]
                origins = np.stack(
                    [lens_u, lens_v, np.zeros(n)], 1)
                dirs = focal_p - origins
                dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

            rec = _intersect(scene, origins, dirs, t)
            diffuse, specular, visibility, ldir = _shade(
                scene, rec, dirs, rng)

            depth = np.where(rec["hit"], rec["t"], 0.0)
            has_hit = rec["hit"].astype(np.float32)
            normal = rec["normal"]
            albedo = rec["albedo"]

            def img(x):
                return x.reshape(ts, ts, -1).transpose(2, 0, 1)

            pix = np.concatenate([
                img(diffuse), img(specular), img(albedo), img(normal),
                img(depth[:, None]), img(visibility[:, None]),
                img(has_hit[:, None])], 0)
            acc += pix
            acc2 += pix ** 2

            if record:
                # Normalized depth like the reference writer
                # (1 / (10 * scene_radius) scaling).
                dnorm = depth / (10 * scene_radius)
                rows = [img(dx[:, None]), img(dy[:, None]),
                        img(lens_u[:, None]), img(lens_v[:, None]),
                        img(t[:, None]), img(diffuse), img(specular),
                        img(normal), img(normal),
                        img(dnorm[:, None]), img(dnorm[:, None]),
                        img(visibility[:, None]), img(has_hit[:, None]),
                        img(albedo), img(albedo)]
                feats[s] = np.concatenate(rows, 0)
        mean = acc / count
        var = acc2 / count - mean ** 2
        return mean.astype(np.float32), np.maximum(var, 0).astype(
            np.float32), feats

    gt_mean, gt_var, _ = sample_pass(gt_spp, record=False)
    _, _, feats = sample_pass(spp, record=True)

    p = np.abs(rng.normal(0.5, 0.2, (spp, 4 * pd, ts, ts))).astype(
        np.float32)
    p = np.log(p + 1e-8) / 30.0  # probability normalization (reference)
    ld = rng.uniform(-np.pi, np.pi, (spp, 2 * pd, ts, ts)).astype(np.float32)
    bt = np.zeros((spp, pd, ts, ts), np.int16)
    bt[:, 0] = 1 | (1 << 2)  # first bounce: diffuse reflection

    return bin_format.Tile(
        tile_size=ts, image_width=image_width, image_height=image_height,
        sample_count=spp, gt_sample_count=gt_spp,
        focus_distance=(scene.focus_distance if scene.aperture > 0 else 0.0),
        aperture_radius=scene.aperture, fov=scene.fov / 100.0,
        scene_radius=scene_radius, block_x=block_x, block_y=block_y,
        pixel_data=np.concatenate([gt_mean, gt_var], 0),
        features=feats, p=p, ld=ld, bt=bt)


def generate_dataset(outdir, n_scenes=2, ts=64, tiles_per_side=1, spp=8,
                     gt_spp=64, seed=0):
    """Write a folder-of-scenes synthetic dataset of .bin tiles."""
    import os
    rng = np.random.RandomState(seed)
    for s in range(n_scenes):
        scene = random_scene(rng)
        sdir = os.path.join(outdir, "scene_%04d" % s)
        os.makedirs(sdir, exist_ok=True)
        size = ts * tiles_per_side
        for ty in range(tiles_per_side):
            for tx in range(tiles_per_side):
                tile = render_tile(scene, rng, ts=ts, spp=spp,
                                   gt_spp=gt_spp, block_x=tx * ts,
                                   block_y=ty * ts, image_width=size,
                                   image_height=size)
                bin_format.write_tile(
                    os.path.join(sdir, "tile_%04d_%04d.bin" % (ty, tx)),
                    tile)
    return outdir
