"""The wavefront renderer's scene model (counterpart of the scene half of
``sbmc_tpu/render/pathtracer.py``).

A :class:`TracerScene` is a set of flat arrays: moving spheres, moving
axis-aligned boxes, capped y-axis cylinders and triangle meshes over a
textured ground plane, under one spherical area light and a sky with a sun,
procedural lobes or an equirectangular image. :func:`random_tracer_scene`
draws one from a ``numpy.random.RandomState`` with the same calls in the
same order as the JAX package's, so one seed gives the same scene in both
packages, and :meth:`TracerScene.as_torch` gives the arrays, dtypes and
padding of the JAX package's ``as_jax()``.
"""

import dataclasses
import os as _os
from typing import Optional

import numpy as np
import torch

from sbmc_tpu_torch.data import bin_format

__all__ = ["TracerScene", "random_tracer_scene", "MAX_DEPTH",
           "MAT_DIFFUSE", "MAT_MIRROR", "MAT_GLASS", "MAT_METAL",
           "MAT_PLASTIC", "TEX_CHECKER3D", "TEX_NOISE", "TEX_STRIPES",
           "N_TEX_IMAGES", "TEX_IMG_RES", "N_ENV_LOBES", "BT_REFLECTION",
           "BT_TRANSMISSION", "BT_DIFFUSE", "BT_GLOSSY", "BT_SPECULAR"]

MAX_DEPTH = bin_format.PATH_DEPTH  # 6 vertices: camera hit + 5 bounces

# Bounce-type bitmask (reference: BxDF flags recorded per vertex).
BT_REFLECTION = 1
BT_TRANSMISSION = 1 << 1
BT_DIFFUSE = 1 << 2
BT_GLOSSY = 1 << 3
BT_SPECULAR = 1 << 4

# Material classes (the reference's 7 scene-generator materials collapse
# onto these scattering models: matte/uber -> diffuse, mirror -> mirror,
# glass -> glass, metal -> metal, plastic/substrate -> plastic).
#: Static count of procedural-envmap lobes (padded; zero color = off).
N_ENV_LOBES = 4

MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_METAL = 3
MAT_PLASTIC = 4

# Procedural albedo textures (the role of the reference's Imagemap /
# Checkerboard textures, sbmc/scene_generator/textures.py:30-139 and
# randomizers.py random_texture — 99% of reference materials are
# textured). Active when ``tex_scale > 0``.
TEX_CHECKER3D = 0
TEX_NOISE = 1      # 2-octave hash-lattice value noise (image-map role)
TEX_STRIPES = 2

#: Per-scene image-texture slots (a static count). Scenes
#: with fewer images pad with zeros; slots are referenced by
#: ``tex_image_id`` (-1 = procedural/flat only).
N_TEX_IMAGES = 4
#: Side of every image texture (square, wrap-addressed), read from
#: SBMC_TEX_RES at import as the JAX package reads it (default 64).
TEX_IMG_RES = int(_os.environ.get("SBMC_TEX_RES", "64"))

@dataclasses.dataclass
class TracerScene:
    """Flat-array scene for the wavefront tracer.

    Primitive arrays (``albedos``, ``roughness``, ``motion``, ``mat_type``,
    ``tex_scale``) cover spheres first, then boxes, then capped y-axis
    cylinders, then triangle meshes: length ``n_spheres + n_boxes +
    n_cylinders + n_meshes`` (the reference scene generator's
    Sphere/Cylinder/Plane/TriangleMesh primitive set,
    sbmc/scene_generator/geometry.py:26-188). Meshes are a flat triangle
    soup (``tri_v0/e1/e2``) whose ``tri_prim`` column maps every triangle
    to its mesh's primitive slot for materials/motion — the wavefront
    analog of the reference's per-material OBJ splits
    (sbmc/scene_generator/converters.py:44-224).
    """
    centers: np.ndarray      # [s, 3] sphere centers
    radii: np.ndarray        # [s]
    albedos: np.ndarray      # [p, 3]
    mirror: np.ndarray       # [s] legacy flag; folded into mat_type
    roughness: np.ndarray    # [p] in (0, 1]: glossy lobe width (1 = diffuse)
    motion: np.ndarray       # [p, 3] linear velocity over the shutter
    ground_albedo: np.ndarray  # [3]
    light_pos: np.ndarray    # [3]
    light_radius: float
    light_emission: np.ndarray  # [3]
    sky: np.ndarray          # [3] horizon sky radiance
    fov: float               # degrees
    aperture: float
    focus_distance: float
    cam_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.2, 0.0]))
    scene_radius: float = 12.0
    # --- extended scene surface (defaults reproduce the v1 tracer) -------
    mat_type: Optional[np.ndarray] = None  # [p] MAT_*; derived if None
    tex_scale: Optional[np.ndarray] = None  # [p] texture freq; 0 = none
    #: [p] texture kind per primitive (TEX_*); defaults to 3D checker for
    #: every primitive with ``tex_scale > 0`` (the v1/v2 behavior). The
    #: procedural kinds play the role of the reference's Imagemap /
    #: Checkerboard textures (sbmc/scene_generator/textures.py:30-139).
    tex_kind: Optional[np.ndarray] = None
    ground_tex_kind: int = TEX_CHECKER3D
    ground_tex_scale: float = 1.0
    box_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    box_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    cyl_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    cyl_radius: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    cyl_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    tri_v0: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    tri_e1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    tri_e2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    tri_prim: np.ndarray = dataclasses.field(  # [T] primitive slot per tri
        default_factory=lambda: np.zeros((0,), np.int32))
    n_meshes: int = 0
    sky_zenith: Optional[np.ndarray] = None  # defaults to ``sky`` (constant)
    sun_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    sun_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    sun_exp: float = 200.0
    glass_ior: float = 1.5
    #: Procedural environment lobes: up to ``N_ENV_LOBES`` cosine-power
    #: blobs added to the gradient sky — the role of the reference's random
    #: HDR envmaps (sbmc/scene_generator/randomizers.py random_envmap).
    #: Rows beyond the count are zero-color (disabled).
    env_dirs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    env_colors: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    env_exps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    #: Image textures loaded from disk (the reference's Imagemap /
    #: random texture files, sbmc/scene_generator/textures.py:30-139,
    #: randomizers.py:27-93): [n <= N_TEX_IMAGES, TEX_IMG_RES,
    #: TEX_IMG_RES, 3] linear RGB in [0, 1]; padded to N_TEX_IMAGES
    #: slots on device. ``None`` ships a 0-slot array (separate jit
    #: variant with zero gather cost).
    tex_images: Optional[np.ndarray] = None
    tex_image_id: Optional[np.ndarray] = None  # [p] int32; -1 = none
    ground_tex_image_id: int = -1
    #: Equirectangular HDR environment image [EH, EW, 3] (the reference's
    #: random HDR envmaps, randomizers.py random_envmap); added to the
    #: gradient sky when present.
    env_image: Optional[np.ndarray] = None
    env_image_scale: float = 1.0

    def _n_prims(self):
        return (self.centers.shape[0] + self.box_centers.shape[0]
                + self.cyl_centers.shape[0] + self.n_meshes)

    def arrays(self):
        """The scene as flat float32/int32 numpy arrays and float32 scalars,
        padded as the renderer takes them (the JAX package's ``as_jax()``:
        the same arrays, dtypes and padding)."""
        p = self._n_prims()
        s = self.centers.shape[0]
        mat = self.mat_type
        if mat is None:
            # Legacy derivation from the v1 (mirror, roughness) encoding.
            mat = np.where(np.asarray(self.mirror) > 0.5, MAT_MIRROR,
                           np.where(np.asarray(self.roughness)[:s] < 0.999,
                                    MAT_METAL, MAT_DIFFUSE))
        mat = np.asarray(mat)
        if mat.shape[0] < p:
            mat = np.concatenate([mat, np.zeros(p - mat.shape[0], mat.dtype)])

        def fit(x, shape, fill=0.0):
            x = np.asarray(x, np.float32)
            if x.shape[0] < shape[0]:
                pad = np.full((shape[0] - x.shape[0],) + x.shape[1:], fill,
                              np.float32)
                x = np.concatenate([x, pad])
            return x

        tex = (np.zeros(p) if self.tex_scale is None
               else fit(self.tex_scale, (p,)))
        kind = (np.full(p, TEX_CHECKER3D, np.int32) if self.tex_kind is None
                else np.asarray(fit(self.tex_kind, (p,)), np.int32))
        zen = self.sky if self.sky_zenith is None else self.sky_zenith
        # Environment lobes padded to a static count.
        ed = np.asarray(self.env_dirs, np.float32).reshape(-1, 3)
        ec = np.asarray(self.env_colors, np.float32).reshape(-1, 3)
        ee = np.asarray(self.env_exps, np.float32).reshape(-1)
        ed, ec, ee = ed[:N_ENV_LOBES], ec[:N_ENV_LOBES], ee[:N_ENV_LOBES]
        ed = ed / np.maximum(np.linalg.norm(ed, axis=1, keepdims=True), 1e-8)
        m = ed.shape[0]
        if m < N_ENV_LOBES:
            ed = np.concatenate([ed, np.zeros((N_ENV_LOBES - m, 3),
                                              np.float32)])
            ec = np.concatenate([ec, np.zeros((N_ENV_LOBES - m, 3),
                                              np.float32)])
            ee = np.concatenate([ee, np.ones(N_ENV_LOBES - m, np.float32)])
        # Image textures: padded to the static N_TEX_IMAGES slot count, or
        # no slot at all when the pool is off.
        if self.tex_images is not None and len(self.tex_images):
            ti = np.asarray(self.tex_images, np.float32)
            if ti.shape[1:] != (TEX_IMG_RES, TEX_IMG_RES, 3):
                raise ValueError("tex_images must be [n, %d, %d, 3], got %s"
                                 % (TEX_IMG_RES, TEX_IMG_RES, ti.shape))
            ti = ti[:N_TEX_IMAGES]
            if ti.shape[0] < N_TEX_IMAGES:
                ti = np.concatenate([ti, np.zeros(
                    (N_TEX_IMAGES - ti.shape[0],) + ti.shape[1:],
                    np.float32)])
        else:
            ti = np.zeros((0, TEX_IMG_RES, TEX_IMG_RES, 3), np.float32)
        tid = (np.full(p, -1, np.int32) if self.tex_image_id is None
               else np.asarray(fit(self.tex_image_id, (p,), -1), np.int32))
        ei = (np.zeros((0, 0, 3), np.float32) if self.env_image is None
              else np.asarray(self.env_image, np.float32))
        # Column -> primitive-slot map for the concatenated hit candidates
        # (spheres, boxes, cylinders are their own slot; each triangle maps
        # to its mesh's slot).
        base = (self.centers.shape[0] + self.box_centers.shape[0]
                + self.cyl_centers.shape[0])
        col_slot = np.concatenate([
            np.arange(base, dtype=np.int32),
            np.asarray(self.tri_prim, np.int32).reshape(-1)])

        def f32(x, *shape):
            x = np.asarray(x, np.float32)
            return x.reshape(*shape) if shape else x

        def i32(x, *shape):
            x = np.asarray(x, np.int32)
            return x.reshape(*shape) if shape else x

        return {
            "centers": f32(self.centers, -1, 3),
            "radii": f32(self.radii),
            "box_centers": f32(self.box_centers, -1, 3),
            "box_half": f32(self.box_half, -1, 3),
            "cyl_centers": f32(self.cyl_centers, -1, 3),
            "cyl_radius": f32(self.cyl_radius, -1),
            "cyl_half": f32(self.cyl_half, -1),
            "tri_v0": f32(self.tri_v0, -1, 3),
            "tri_e1": f32(self.tri_e1, -1, 3),
            "tri_e2": f32(self.tri_e2, -1, 3),
            "tri_prim": i32(self.tri_prim, -1),
            "col_slot": i32(col_slot),
            "albedos": fit(self.albedos, (p, 3), 0.5),
            "roughness": fit(self.roughness, (p,), 1.0),
            "motion": fit(self.motion, (p, 3)),
            "mat_type": i32(mat),
            "tex_scale": f32(tex),
            "tex_kind": i32(kind),
            "ground_tex_kind": np.int32(self.ground_tex_kind),
            "ground_tex_scale": np.float32(self.ground_tex_scale),
            "tex_images": f32(ti),
            "tex_image_id": i32(tid),
            "ground_tex_image_id": np.int32(self.ground_tex_image_id),
            "env_image": f32(ei),
            "env_image_scale": np.float32(self.env_image_scale),
            "ground_albedo": f32(self.ground_albedo),
            "light_pos": f32(self.light_pos),
            "light_radius": np.float32(self.light_radius),
            "light_emission": f32(self.light_emission),
            "sky": f32(self.sky),
            "sky_zenith": f32(zen),
            "sun_dir": f32(self.sun_dir),
            "sun_color": f32(self.sun_color),
            "sun_exp": np.float32(self.sun_exp),
            "env_dirs": f32(ed),
            "env_colors": f32(ec),
            "env_exps": f32(ee),
            "glass_ior": np.float32(self.glass_ior),
            "fov": np.float32(self.fov),
            "aperture": np.float32(self.aperture),
            "focus_distance": np.float32(self.focus_distance),
            "cam_pos": f32(self.cam_pos),
            "scene_radius": np.float32(self.scene_radius),
        }

    def as_torch(self, device="cpu"):
        """:meth:`arrays` as tensors on ``device`` (scalars as 0-d
        tensors)."""
        return {name: torch.from_numpy(np.array(x)).to(device)
                for name, x in self.arrays().items()}


#: Platonic-solid templates for random prop meshes (vertices, faces).
_MESH_TEMPLATES = None


def _mesh_templates():
    global _MESH_TEMPLATES
    if _MESH_TEMPLATES is None:
        tet_v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                         np.float64) / np.sqrt(3)
        tet_f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])
        oct_v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
        oct_f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                          [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
        g = (1 + np.sqrt(5)) / 2
        ico_v = np.array([[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
                          [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
                          [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]],
                         np.float64)
        ico_v /= np.linalg.norm(ico_v[0])
        ico_f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                          [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                          [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                          [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                          [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
        _MESH_TEMPLATES = [(tet_v, tet_f), (oct_v, oct_f), (ico_v, ico_f)]
    return _MESH_TEMPLATES


def _random_mesh(rng):
    """A jittered, rotated, scaled platonic solid resting above the ground
    (the wavefront stand-in for the reference's random OBJ props,
    sbmc/scene_generator/generators.py random model placement)."""
    verts, faces = _mesh_templates()[rng.randint(3)]
    verts = verts.copy() * rng.uniform(0.4, 1.1)
    verts += rng.normal(0, 0.08, verts.shape)      # break the symmetry
    # Random rotation from a QR decomposition.
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    verts = verts @ q.T
    center = np.array([rng.uniform(-3.5, 3.5),
                       0.0,
                       rng.uniform(3.0, 9.0)])
    verts += center
    verts[:, 1] += 0.05 - verts[:, 1].min()        # rest on the ground
    return verts, faces


def _place_mesh(rng, verts):
    """Scale / rotate / drop a normalized mesh onto the ground plane (the
    shared placement law for procedural and .obj props)."""
    verts = verts.copy() * rng.uniform(0.4, 1.1)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    verts = verts @ q.T
    verts += np.array([rng.uniform(-3.5, 3.5), 0.0,
                       rng.uniform(3.0, 9.0)])
    verts[:, 1] += 0.05 - verts[:, 1].min()
    return verts


def random_tracer_scene(rng, n_spheres=6, n_boxes=3, n_cyls=2, n_meshes=2,
                        obj_pool=None, obj_prob=0.6, tri_bucket=64,
                        tex_pool=None, img_prob=0.5, env_pool=None,
                        env_img_prob=0.4):
    """Sample a random scene with the reference's material-mixture spirit
    (sbmc/scene_generator/randomizers.py:194-227: 5% mirror, 5% glass,
    10% metal, 20% plastic, 10% substrate, 30% uber, 20% diffuse — the
    pbrt-only classes collapse onto our five scattering models).

    ``obj_pool`` (a :class:`sbmc_tpu_torch.render.assets.ObjPool`) substitutes
    ingested .obj geometry for the procedural platonic solids with
    probability ``obj_prob`` per mesh slot (the reference's random model
    placement, sbmc/scene_generator/generators.py). Triangle arrays are
    padded with degenerate (never-hit) triangles to the next power-of-two
    rung at least ``tri_bucket`` so scenes with different meshes share XLA
    compilations (<= 5 distinct shapes per corpus).

    ``tex_pool`` (:class:`sbmc_tpu_torch.render.assets.TexturePool`) draws up to
    ``N_TEX_IMAGES`` image textures per scene and assigns them to textured
    slots (and the ground) with probability ``img_prob`` — the reference's
    randomized Imagemap materials (randomizers.py:27-93, 99% of materials
    textured). ``env_pool`` (:class:`EnvmapPool`) substitutes an equirect
    HDR image for the procedural envmap lobes with probability
    ``env_img_prob`` (randomizers.py random_envmap).
    """
    p = n_spheres + n_boxes + n_cyls + n_meshes
    mat = rng.choice(
        [MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS, MAT_METAL, MAT_PLASTIC],
        size=p, p=[0.50, 0.05, 0.05, 0.10, 0.30])
    do_motion = rng.rand(p) < 0.25
    sunny = rng.rand() < 0.5
    sun = rng.normal(size=3)
    sun[1] = abs(sun[1]) + 0.3
    sun /= np.linalg.norm(sun)
    # Procedural envmap: 1..N_ENV_LOBES colored blobs 60% of the time
    # (reference: random envmap textures, scene_generator/randomizers.py).
    n_lobes = rng.randint(1, N_ENV_LOBES + 1)
    env_on = rng.rand() < 0.6
    env_dirs = rng.normal(size=(n_lobes, 3))
    env_dirs[:, 1] = np.abs(env_dirs[:, 1]) + 0.1
    env_colors = rng.uniform(0.2, 2.5, (n_lobes, 3)) * env_on
    env_exps = np.exp(rng.uniform(np.log(2.0), np.log(64.0), n_lobes))
    env_image = None
    env_image_scale = 1.0
    if env_pool is not None:
        if rng.rand() < env_img_prob:
            env_image = env_pool.sample(rng)
            env_image_scale = float(np.exp(rng.uniform(np.log(0.3),
                                                       np.log(2.0))))
            env_colors = env_colors * 0.0  # the image replaces the lobes
        else:
            # Keep the traced shape identical to the image-envmap case
            # (a zero image at scale 0 contributes exactly nothing):
            # with an env pool in play, image-vs-lobes otherwise doubles
            # the XLA executable count across a datagen corpus.
            env_image = np.zeros(env_pool.res + (3,), np.float32)
            env_image_scale = 0.0

    tex_images = None
    tex_image_id = None
    ground_tex_image_id = -1
    if tex_pool is not None:
        n_img = int(rng.randint(1, N_TEX_IMAGES + 1))
        tex_images = np.stack([tex_pool.sample(rng) for _ in range(n_img)])
        tex_image_id = np.where(
            rng.rand(p) < img_prob, rng.randint(0, n_img, p),
            -1).astype(np.int32)
        if rng.rand() < img_prob:
            ground_tex_image_id = int(rng.randint(0, n_img))

    centers = np.stack([rng.uniform(-3, 3, n_spheres),
                        rng.uniform(0.4, 2.5, n_spheres),
                        rng.uniform(3.0, 9.0, n_spheres)], 1)
    radii = rng.uniform(0.3, 1.0, n_spheres)
    box_half = np.stack([rng.uniform(0.25, 0.9, n_boxes),
                         rng.uniform(0.25, 1.2, n_boxes),
                         rng.uniform(0.25, 0.9, n_boxes)], 1)
    box_centers = np.stack([rng.uniform(-3.5, 3.5, n_boxes),
                            box_half[:, 1] * (1 + 1.5 * rng.rand(n_boxes)),
                            rng.uniform(3.0, 9.0, n_boxes)], 1)
    cyl_radius = rng.uniform(0.2, 0.7, n_cyls)
    cyl_half = rng.uniform(0.3, 1.3, n_cyls)
    cyl_centers = np.stack([rng.uniform(-3.5, 3.5, n_cyls),
                            cyl_half * (1 + 1.5 * rng.rand(n_cyls)),
                            rng.uniform(3.0, 9.0, n_cyls)], 1)

    tri_v0, tri_e1, tri_e2, tri_prim = [], [], [], []
    mesh_verts = []
    base = n_spheres + n_boxes + n_cyls
    for mi in range(n_meshes):
        if obj_pool is not None and rng.rand() < obj_prob:
            nverts, faces = obj_pool.sample(rng)
            verts = _place_mesh(rng, nverts)
        else:
            verts, faces = _random_mesh(rng)
        mesh_verts.append(verts)
        v0 = verts[faces[:, 0]]
        tri_v0.append(v0)
        tri_e1.append(verts[faces[:, 1]] - v0)
        tri_e2.append(verts[faces[:, 2]] - v0)
        tri_prim.append(np.full(len(faces), base + mi, np.int32))
    cat = lambda xs, d: (np.concatenate(xs)  # noqa: E731
                         if xs else np.zeros((0,) + d, np.float32))
    tri_v0 = cat(tri_v0, (3,))
    tri_e1 = cat(tri_e1, (3,))
    tri_e2 = cat(tri_e2, (3,))
    tri_prim = (np.concatenate(tri_prim) if tri_prim
                else np.zeros((0,), np.int32))
    if tri_bucket and len(tri_v0):
        # Pad to a power-of-two rung (at least ``tri_bucket``) with
        # zero-area triangles (det == 0 in _tri_ts -> never hit). A
        # fixed-multiple bucket still produced ~17 distinct triangle
        # counts across a mixed obj/procedural corpus, and the resulting
        # executable zoo made XLA compilation 40-55% of datagen wall
        # clock (round-4 overnight logs); pow2 rungs collapse that to
        # <= 5 shapes at a mean ~1.3x padding cost on the (MXU-batched)
        # triangle intersection only.
        target = max(tri_bucket, 1 << int(np.ceil(np.log2(len(tri_v0)))))
        pad = target - len(tri_v0)
        if pad:
            zeros3 = np.zeros((pad, 3), np.float32)
            tri_v0 = np.concatenate([tri_v0, zeros3])
            tri_e1 = np.concatenate([tri_e1, zeros3])
            tri_e2 = np.concatenate([tri_e2, zeros3])
            tri_prim = np.concatenate(
                [tri_prim, np.full(pad, base, np.int32)])

    # Scene radius: the reference PBRT computes it from the world bound;
    # use the camera-to-farthest-surface distance (plus light) here.
    cam = np.array([rng.uniform(-1, 1), rng.uniform(0.8, 2.2),
                    rng.uniform(-1, 1)])
    light_pos = np.array([rng.uniform(-4, 4), rng.uniform(4, 8),
                          rng.uniform(0, 6)])
    ext = max(
        float(np.max(np.linalg.norm(centers - cam, axis=1) + radii)),
        float(np.max(np.linalg.norm(box_centers - cam, axis=1)
                     + np.linalg.norm(box_half, axis=1))),
        float(np.max(np.linalg.norm(cyl_centers - cam, axis=1)
                     + np.hypot(cyl_radius, cyl_half))) if n_cyls else 0.0,
        max((float(np.max(np.linalg.norm(v - cam, axis=1)))
             for v in mesh_verts), default=0.0),
        float(np.linalg.norm(light_pos - cam)))

    return TracerScene(
        centers=centers,
        radii=radii,
        albedos=rng.uniform(0.1, 0.9, (p, 3)),
        mirror=(mat[:n_spheres] == MAT_MIRROR).astype(np.float32),
        roughness=np.where(
            np.isin(mat, [MAT_METAL, MAT_PLASTIC]),
            rng.uniform(0.05, 0.4, p), 1.0),
        motion=rng.normal(0, 0.15, (p, 3)) * do_motion[:, None],
        mat_type=mat,
        # 70% textured (the reference leaves only 1% untextured, but its
        # image maps are often low-contrast; keep some flat albedos).
        tex_scale=np.where(rng.rand(p) < 0.7, rng.uniform(0.5, 3.0, p), 0.0),
        tex_kind=rng.choice([TEX_CHECKER3D, TEX_NOISE, TEX_STRIPES],
                            size=p, p=[0.4, 0.35, 0.25]),
        ground_tex_kind=int(rng.choice(
            [TEX_CHECKER3D, TEX_NOISE, TEX_STRIPES], p=[0.5, 0.3, 0.2])),
        ground_tex_scale=float(rng.uniform(0.3, 2.0)),
        box_centers=box_centers,
        box_half=box_half,
        cyl_centers=cyl_centers,
        cyl_radius=cyl_radius,
        cyl_half=cyl_half,
        tri_v0=tri_v0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_prim=tri_prim,
        n_meshes=n_meshes,
        ground_albedo=rng.uniform(0.2, 0.8, 3),
        light_pos=light_pos,
        light_radius=float(rng.uniform(0.2, 0.8)),
        light_emission=rng.uniform(30, 120, 3),
        sky=rng.uniform(0.05, 0.35, 3),
        sky_zenith=rng.uniform(0.05, 0.6, 3),
        sun_dir=sun,
        sun_color=rng.uniform(3, 30, 3) * sunny,
        sun_exp=float(rng.uniform(50, 500)),
        env_dirs=env_dirs,
        env_colors=env_colors,
        env_exps=env_exps,
        tex_images=tex_images,
        tex_image_id=tex_image_id,
        ground_tex_image_id=ground_tex_image_id,
        env_image=env_image,
        env_image_scale=env_image_scale,
        fov=float(rng.uniform(25, 60)),
        aperture=(float(np.exp(rng.uniform(np.log(1e-3), np.log(0.05))))
                  if rng.rand() < 0.5 else 0.0),
        focus_distance=float(rng.uniform(3, 8)),
        cam_pos=cam,
        scene_radius=float(max(ext * 1.1, 4.0)),
    )

