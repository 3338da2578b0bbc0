"""OBJ mesh, texture and envmap ingestion for the wavefront tracer
(counterpart of ``sbmc_tpu/render/assets.py``).

The reference's training distribution leans on random .obj props placed in
the frustum (reference: sbmc/scene_generator/generators.py random model
placement via ObjConverter, converters.py:44-224). The wavefront tracer
consumes raw triangle arrays, so ingestion here is a direct .obj ->
(vertices, faces) parse plus normalization — no pbrt round-trip needed.

The tracer has no BVH (every ray tests every triangle), so triangle COUNT
is the cost driver: the pool enforces a per-mesh face cap, and scenes pad
their triangle arrays to a power-of-two bucket (degenerate zero-area
triangles never hit).

Images are read without ``imageio``: PNG through
:func:`sbmc_tpu_torch.utils.image.read_png`, EXR through
:mod:`sbmc_tpu_torch.utils.exr`. JPEG raises ``NotImplementedError``: the
port has no JPEG decoder (the repo's assets hold none).
"""

import os

import numpy as np

from sbmc_tpu_torch.utils.image import read_png

__all__ = ["load_obj", "normalize_mesh", "ObjPool", "TexturePool",
           "EnvmapPool"]


def load_obj(path, max_faces=None):
    """Parse a Wavefront .obj into (verts [V,3] f32, faces [F,3] i32).

    Supports ``v`` / ``f`` records, ``v/vt/vn`` face syntax, negative
    (relative) indices, and polygon fan triangulation. Everything else
    (normals, texcoords, materials, groups) is ignored — the tracer
    computes geometric normals and assigns its own materials.
    """
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                nv = len(verts)
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else nv + i)
                for k in range(1, len(idx) - 1):   # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if max_faces is not None and len(faces) > max_faces:
                        raise ValueError(
                            f"{path}: more than {max_faces} triangles")
    if not verts or not faces:
        raise ValueError(f"{path}: no geometry")
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError(f"{path}: face index out of range")
    return v, f


def normalize_mesh(verts):
    """Center at the origin and scale to unit max-radius (so pool meshes
    compose with the same placement law as the procedural props)."""
    v = verts - verts.mean(0, keepdims=True)
    r = float(np.linalg.norm(v, axis=1).max())
    return v / max(r, 1e-8)


class ObjPool:
    """A lazily-loaded pool of .obj meshes for random scene synthesis.

    Args:
      source: a directory (searched recursively for ``*.obj``) or an
        explicit list of paths.
      max_faces: skip meshes with more triangles than this (tracer cost
        guard; default the ``SBMC_MAX_FACES`` env knob or 512).
    """

    def __init__(self, source, max_faces=None):
        if max_faces is None:
            max_faces = int(os.environ.get("SBMC_MAX_FACES", "512"))
        if isinstance(source, (list, tuple)):
            self.paths = list(source)
        else:
            self.paths = sorted(
                os.path.join(r, n)
                for r, _, names in os.walk(source)
                for n in names if n.lower().endswith(".obj"))
        if not self.paths:
            raise ValueError(f"no .obj files under {source!r}")
        self.max_faces = max_faces
        self._cache = {}
        self._bad = set()

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        if path in self._cache:
            return self._cache[path]
        v, f = load_obj(path, max_faces=self.max_faces)
        v = normalize_mesh(v)
        self._cache[path] = (v, f)
        return v, f

    def sample(self, rng):
        """A random (normalized_verts, faces) pair; unparseable/oversized
        entries are skipped (and remembered) rather than fatal."""
        order = rng.permutation(len(self.paths))
        for i in order:
            path = self.paths[int(i)]
            if path in self._bad:
                continue
            try:
                return self._load(path)
            except (ValueError, OSError, IndexError):
                self._bad.add(path)
        raise ValueError("every mesh in the pool failed to load")


def _load_image(path):
    """Read an image file into linear-RGB float32 [H, W, 3].

    8- and 16-bit PNGs are assumed sRGB-encoded and linearized with the
    gamma-2.2 approximation; EXR is linear already."""
    lower = path.lower()
    if lower.endswith(".exr"):
        from sbmc_tpu_torch.utils import exr
        im = np.asarray(exr.read(path), np.float32)
    elif lower.endswith((".jpg", ".jpeg")):
        raise NotImplementedError(
            f"{path}: the port has no JPEG decoder; convert the texture to "
            "PNG or EXR")
    else:
        im = read_png(path)
        if im.dtype == np.uint8:
            im = (im.astype(np.float32) / 255.0) ** 2.2
        elif im.dtype == np.uint16:
            im = (im.astype(np.float32) / 65535.0) ** 2.2
        else:
            im = im.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    if im.shape[2] == 1:
        im = np.repeat(im, 3, 2)
    return np.ascontiguousarray(im[:, :, :3], np.float32)


def _resample_nn(im, h, w):
    """Nearest-neighbor resample (assets are noise-like training textures,
    filtering quality is irrelevant; keeps the loader dependency-free)."""
    ys = (np.arange(h) * im.shape[0] // h).clip(0, im.shape[0] - 1)
    xs = (np.arange(w) * im.shape[1] // w).clip(0, im.shape[1] - 1)
    return im[ys][:, xs]


class _ImagePool:
    """Shared lazy image-pool machinery (see TexturePool / EnvmapPool)."""

    _exts = (".png", ".jpg", ".jpeg", ".exr")

    def __init__(self, source):
        if isinstance(source, (list, tuple)):
            self.paths = list(source)
        else:
            self.paths = sorted(
                os.path.join(r, n)
                for r, _, names in os.walk(source)
                for n in names if n.lower().endswith(self._exts))
        if not self.paths:
            raise ValueError(f"no image files under {source!r}")
        self._cache = {}
        self._bad = set()

    def __len__(self):
        return len(self.paths)

    def _prepare(self, im):
        raise NotImplementedError

    def _load(self, path):
        if path not in self._cache:
            self._cache[path] = self._prepare(_load_image(path))
        return self._cache[path]

    def sample(self, rng):
        order = rng.permutation(len(self.paths))
        for i in order:
            path = self.paths[int(i)]
            if path in self._bad:
                continue
            try:
                return self._load(path)
            except (ValueError, OSError, IndexError, ImportError):
                self._bad.add(path)
        raise ValueError("every image in the pool failed to load")


class TexturePool(_ImagePool):
    """Image textures for the tracer's Imagemap role: resampled to the
    tracer's fixed ``TEX_IMG_RES`` square and clipped to [0, 1]."""

    def _prepare(self, im):
        from sbmc_tpu_torch.render.scene import TEX_IMG_RES
        im = _resample_nn(im, TEX_IMG_RES, TEX_IMG_RES)
        return np.clip(im, 0.0, 1.0)


class EnvmapPool(_ImagePool):
    """Equirectangular HDR environment images (2:1 aspect enforced by
    resampling to ``SBMC_ENV_RES`` x ``2*SBMC_ENV_RES``, default 64x128);
    negative values clipped, HDR range kept."""

    @property
    def res(self):
        """(H, W) every pooled envmap is resampled to (one shape for a
        whole corpus)."""
        eh = int(os.environ.get("SBMC_ENV_RES", "64"))
        return (eh, 2 * eh)

    def _prepare(self, im):
        im = _resample_nn(im, *self.res)
        return np.maximum(im, 0.0)
