"""The port's scene model and asset pools against the JAX package's.

``random_tracer_scene`` draws from a ``numpy.random.RandomState`` with the
same calls in the same order in both packages, so one seed must give the
same arrays from ``as_torch("cpu")`` as from ``as_jax()``: byte for byte,
same dtypes and shapes. The pools read their files with the port's own PNG
and EXR readers (the card's machine has no ``imageio``); ``read_png`` must
give ``imageio``'s arrays bit for bit.
"""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from sbmc_tpu.render import assets as jassets
from sbmc_tpu.render import pathtracer as jpt
from sbmc_tpu_torch.render import assets, scene
from sbmc_tpu_torch.utils.image import read_png

TEXTURES = "assets/textures"
POOLS = {"obj_pool": ("assets/objs", "ObjPool"),
         "tex_pool": (TEXTURES, "TexturePool"),
         "env_pool": ("assets/envmaps", "EnvmapPool")}


def _pools(module, names):
    return {name: getattr(module, POOLS[name][1])(POOLS[name][0])
            for name in names}


def _assert_same_arrays(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("pools", [(), ("obj_pool",), ("tex_pool",),
                                   ("env_pool",),
                                   ("obj_pool", "tex_pool", "env_pool")])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_scene_arrays_identical(seed, pools):
    got = scene.random_tracer_scene(np.random.RandomState(seed),
                                    **_pools(assets, pools))
    want = jpt.random_tracer_scene(np.random.RandomState(seed),
                                   **_pools(jassets, pools))
    _assert_same_arrays(got.as_torch("cpu"), want.as_jax())


def test_legacy_scene_arrays_identical():
    """A hand-built scene: material types derived from the v1 (mirror,
    roughness) encoding, no boxes, cylinders or meshes, default texture
    kinds and no environment lobes."""
    kw = dict(centers=np.array([[0.0, 1.0, 5.0], [1.0, 0.5, 4.0]]),
              radii=np.array([1.0, 0.5]),
              albedos=np.array([[0.8, 0.2, 0.2], [0.1, 0.9, 0.3]]),
              mirror=np.array([1.0, 0.0]), roughness=np.array([1.0, 0.3]),
              motion=np.zeros((2, 3)), ground_albedo=np.full(3, 0.5),
              light_pos=np.array([0.0, 6.0, 3.0]), light_radius=0.5,
              light_emission=np.full(3, 60.0), sky=np.full(3, 0.1),
              fov=45.0, aperture=0.0, focus_distance=5.0,
              tex_scale=np.array([1.5, 0.0]))
    _assert_same_arrays(scene.TracerScene(**kw).as_torch("cpu"),
                        jpt.TracerScene(**kw).as_jax())


def test_largest_triangle_bucket():
    """The repo's meshes pad to at most 1024 triangles: a scene holds two
    meshes, the largest has 360 faces, and the pair rounds up to the next
    power of two (the bucket the card's kernel check uses)."""
    pool = assets.ObjPool("assets/objs")
    faces = max(len(pool._load(p)[1]) for p in pool.paths)
    assert faces == 360
    assert 1 << int(np.ceil(np.log2(2 * faces))) == 1024


def test_obj_pool_matches_jax():
    got, want = assets.ObjPool("assets/objs"), jassets.ObjPool("assets/objs")
    assert got.paths == want.paths
    for path in got.paths:
        for a, b in zip(got._load(path), want._load(path)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["TexturePool", "EnvmapPool"])
def test_image_pools_match_jax(name):
    folder = TEXTURES if name == "TexturePool" else "assets/envmaps"
    got, want = getattr(assets, name)(folder), getattr(jassets, name)(folder)
    assert got.paths == want.paths
    for path in got.paths:
        np.testing.assert_array_equal(got._load(path), want._load(path))


@pytest.mark.parametrize("path", sorted(
    __import__("glob").glob(TEXTURES + "/*.png")))
def test_read_png_matches_imageio(path):
    got, want = read_png(path), imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(path, img, depth, ctype):
    """A PNG whose rows cycle through the five filter types."""
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    raw = (img.astype(">u2") if depth == 16 else img.astype(np.uint8))
    rows = raw.reshape(h, -1).view(np.uint8).astype(np.int64)
    bpp = c * depth // 8
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        ftype, line = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            enc = line
        elif ftype == 1:
            enc = line - left
        elif ftype == 2:
            enc = line - prior
        elif ftype == 3:
            enc = line - (left + prior) // 2
        else:
            enc = line - np.array([_paeth(a, b, cc) for a, b, cc in
                                   zip(left, prior, upleft)])
        out.append(bytes([ftype]) + (enc & 255).astype(np.uint8).tobytes())
        prior = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_read_png_formats(tmp_path, depth, ctype, channels):
    """Every colour type at both depths, every row filter: the decoded
    pixels are the encoded ones (and imageio's, where it keeps the depth)."""
    rng = np.random.RandomState(depth + ctype)
    shape = (11, 7) if channels == 1 else (11, 7, channels)
    img = rng.randint(0, 2 ** depth, shape).astype(
        np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / "t.png")
    _encode_png(path, img, depth, ctype)
    got = read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    if depth == 8 or channels == 1:
        np.testing.assert_array_equal(got, imageio.imread(path))


def test_jpeg_raises(tmp_path):
    path = tmp_path / "t.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="JPEG"):
        assets._load_image(str(path))
    pool = assets.TexturePool([str(path)])
    with pytest.raises(NotImplementedError, match="JPEG"):
        pool.sample(np.random.RandomState(0))


def test_read_png_rejects_damage(tmp_path):
    path = tmp_path / "t.png"
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(path))
