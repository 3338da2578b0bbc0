"""Reader/writer for the ``.bin`` per-sample tile format (a copy of
``sbmc_tpu/data/bin_format.py``).

Byte-compatible with the format produced by the reference's patched PBRTv2
renderer (SampleRecord::save, pbrt_patches/sbmc_pbrt.diff) and consumed by
the reference loader (sbmc/datasets.py:501-739):

.. code-block:: text

    int32 x 9  : version, tile_size, image_width, image_height,
                 sample_count, gt_sample_count, sample_features,
                 pixel_features, path_depth
    float32 x 4: focus_distance, aperture_radius, fov, scene_radius
    int32 x 2  : block_x, block_y
    [int32 nbytes][lz4-frame]           : pixel block
                 (pixel_features, ts, ts) float32 = 15 mean + 15 variance
                 channels (diffuse, specular, albedo, normal, depth,
                 visibility, hasHit)
    per sample : [int32 nbytes][lz4-frame] containing, contiguously:
                 (sample_features, ts, ts) float32 sample features,
                 (4 * path_depth, ts, ts) float32 sampling probabilities,
                 (2 * path_depth, ts, ts) float32 light directions,
                 (path_depth, ts, ts) int16 bounce-type bitmasks

The 27 sample-feature channels are, in order: dx, dy, lens_u, lens_v, t,
diffuse rgb, specular rgb, normal_first xyz, normal xyz, depth_first, depth,
visibility, hasHit, albedo_first rgb, albedo rgb.
"""

import dataclasses
import os
import struct

import numpy as np

from sbmc_tpu_torch.data import _native, lz4f

__all__ = ["Tile", "read_tile", "write_tile", "read_header",
           "decode_bounce_types",
           "VERSION", "VALID_VERSIONS", "SAMPLE_FEATURES", "PIXEL_FEATURES",
           "PATH_DEPTH", "SAMPLE_FEATURE_LABELS", "PIXEL_CHANNEL_LABELS"]

VERSION = 20190401
VALID_VERSIONS = (20181212, 20190401)
SAMPLE_FEATURES = 27
PIXEL_FEATURES = 30
PATH_DEPTH = 6

SAMPLE_FEATURE_LABELS = [
    "dx", "dy", "lens_u", "lens_v", "t",
    "diffuse_r", "diffuse_g", "diffuse_b",
    "specular_r", "specular_g", "specular_b",
    "normal_first_x", "normal_first_y", "normal_first_z",
    "normal_x", "normal_y", "normal_z",
    "depth_first", "depth", "visibility", "hasHit",
    "albedo_first_r", "albedo_first_g", "albedo_first_b",
    "albedo_r", "albedo_g", "albedo_b",
]

PIXEL_CHANNEL_LABELS = [
    "diffuse_r", "diffuse_g", "diffuse_b",
    "specular_r", "specular_g", "specular_b",
    "albedo_r", "albedo_g", "albedo_b",
    "normal_x", "normal_y", "normal_z",
    "depth", "visibility", "hasHit",
]


@dataclasses.dataclass
class Tile:
    """In-memory representation of one sample tile."""
    tile_size: int
    image_width: int
    image_height: int
    sample_count: int
    gt_sample_count: int
    focus_distance: float
    aperture_radius: float
    fov: float
    scene_radius: float
    block_x: int
    block_y: int
    pixel_data: np.ndarray        # (PIXEL_FEATURES, ts, ts) float32
    features: np.ndarray          # (spp, SAMPLE_FEATURES, ts, ts) float32
    p: np.ndarray                 # (spp, 4*PATH_DEPTH, ts, ts) float32
    ld: np.ndarray                # (spp, 2*PATH_DEPTH, ts, ts) float32
    bt: np.ndarray                # (spp, PATH_DEPTH, ts, ts) int16
    version: int = VERSION
    sample_features: int = SAMPLE_FEATURES
    pixel_features: int = PIXEL_FEATURES
    path_depth: int = PATH_DEPTH


def _write_compressed(fid, arr):
    buf = lz4f.compress(np.ascontiguousarray(arr).tobytes())
    fid.write(struct.pack("i", len(buf)))
    fid.write(buf)


def _read_compressed(fid, expected_size=None):
    nbytes = struct.unpack("i", fid.read(4))[0]
    return lz4f.decompress(fid.read(nbytes), expected_size)


def write_tile(path, tile):
    """Serialize a :class:`Tile` to ``path`` in the reference format.

    Written via tmp + atomic rename: unattended datagen runs are killed
    by window timeouts mid-corpus, and a truncated ``.bin`` would crash
    every later training run that globs the directory."""
    tmp = path + ".tmp"
    _write_tile_inner(tmp, tile)
    os.replace(tmp, path)


def _write_tile_inner(path, tile):
    ts = tile.tile_size
    spp = tile.sample_count
    assert tile.pixel_data.shape == (tile.pixel_features, ts, ts)
    assert tile.features.shape == (spp, tile.sample_features, ts, ts)
    assert tile.p.shape == (spp, 4 * tile.path_depth, ts, ts)
    assert tile.ld.shape == (spp, 2 * tile.path_depth, ts, ts)
    assert tile.bt.shape == (spp, tile.path_depth, ts, ts)
    with open(path, "wb") as fid:
        fid.write(struct.pack(
            "9i", tile.version, ts, tile.image_width, tile.image_height,
            spp, tile.gt_sample_count, tile.sample_features,
            tile.pixel_features, tile.path_depth))
        fid.write(struct.pack(
            "4f", tile.focus_distance, tile.aperture_radius, tile.fov,
            tile.scene_radius))
        fid.write(struct.pack("2i", tile.block_x, tile.block_y))
        _write_compressed(fid, tile.pixel_data.astype(np.float32))
        for s in range(spp):
            payload = (
                tile.features[s].astype(np.float32).tobytes()
                + tile.p[s].astype(np.float32).tobytes()
                + tile.ld[s].astype(np.float32).tobytes()
                + tile.bt[s].astype(np.int16).tobytes())
            buf = lz4f.compress(payload)
            fid.write(struct.pack("i", len(buf)))
            fid.write(buf)


def read_header(fid):
    """Read and validate header + globals; returns (meta dict, gfeatures
    dict) mirroring the reference's `_read_globals_and_meta`
    (sbmc/datasets.py:501-550)."""
    meta = {}
    (meta["version"], meta["tile_size"], meta["image_width"],
     meta["image_height"], meta["sample_count"], meta["gt_sample_count"],
     meta["sample_features"], meta["pixel_features"],
     meta["path_depth"]) = struct.unpack("9i", fid.read(36))
    if meta["version"] not in VALID_VERSIONS:
        raise ValueError("Version unsupported: got %s, valid are %s" %
                         (meta["version"], list(VALID_VERSIONS)))
    gfeatures = {}
    (gfeatures["focus_distance"], gfeatures["aperture_radius"],
     gfeatures["fov"], gfeatures["scene_radius"]) = struct.unpack(
        "4f", fid.read(16))
    # NaN focus distance when DoF is off breaks the network; zero it
    # (reference: sbmc/datasets.py:532-535).
    if gfeatures["aperture_radius"] == 0:
        gfeatures["focus_distance"] = 0.0
    for key in ("focus_distance", "aperture_radius", "fov", "scene_radius"):
        if gfeatures[key] < 0:
            raise ValueError(f"{key} is negative: data is corrupt.")
    return meta, gfeatures


def read_tile(path, spp=None, num_threads=0):
    """Read a ``.bin`` tile fully into a :class:`Tile`.

    The sample blocks are decoded by the native multithreaded decoder
    (``src/fastbin.cpp``, :mod:`sbmc_tpu_torch.data._native`) where it can
    be built, else in Python; both give the same arrays.

    Args:
      path: file path.
      spp: optional number of samples to load (defaults to all).
      num_threads: decode threads for the native decoder (0: the CPU
        count, at most 8).
    """
    import io

    with open(path, "rb") as f:
        raw = f.read()
    fid = io.BytesIO(raw)
    meta, gf = read_header(fid)
    ts = meta["tile_size"]
    pd = meta["path_depth"]
    sf = meta["sample_features"]
    n = meta["sample_count"] if spp is None else spp
    if n > meta["sample_count"]:
        raise ValueError("Requested too many samples.")
    block_x, block_y = struct.unpack("2i", fid.read(8))
    pix = np.frombuffer(
        _read_compressed(fid, meta["pixel_features"] * ts * ts * 4),
        np.float32).reshape(meta["pixel_features"], ts, ts)

    feats = np.empty((n, sf, ts, ts), np.float32)
    p = np.empty((n, 4 * pd, ts, ts), np.float32)
    ld = np.empty((n, 2 * pd, ts, ts), np.float32)
    bt = np.empty((n, pd, ts, ts), np.int16)
    f_b = sf * ts * ts * 4
    p_b = 4 * pd * ts * ts * 4
    ld_b = 2 * pd * ts * ts * 4
    bt_b = pd * ts * ts * 2
    total = f_b + p_b + ld_b + bt_b

    native = _native.get()
    if native is not None and n > 0:
        if num_threads <= 0:
            num_threads = min(os.cpu_count() or 1, 8)
        native.decode_sample_blocks(
            raw, fid.tell(), n, f_b, p_b, ld_b, bt_b,
            feats, p, ld, bt, num_threads)
    else:
        for s in range(n):
            buf = _read_compressed(fid, total)
            off = 0
            feats[s] = np.frombuffer(buf[off:off + f_b],
                                     np.float32).reshape(sf, ts, ts)
            off += f_b
            p[s] = np.frombuffer(buf[off:off + p_b],
                                 np.float32).reshape(4 * pd, ts, ts)
            off += p_b
            ld[s] = np.frombuffer(buf[off:off + ld_b],
                                  np.float32).reshape(2 * pd, ts, ts)
            off += ld_b
            bt[s] = np.frombuffer(buf[off:off + bt_b],
                                  np.int16).reshape(pd, ts, ts)

    return Tile(
        tile_size=ts, image_width=meta["image_width"],
        image_height=meta["image_height"], sample_count=n,
        gt_sample_count=meta["gt_sample_count"],
        focus_distance=gf["focus_distance"],
        aperture_radius=gf["aperture_radius"], fov=gf["fov"],
        scene_radius=gf["scene_radius"], block_x=block_x, block_y=block_y,
        pixel_data=pix, features=feats, p=p, ld=ld, bt=bt,
        version=meta["version"], sample_features=sf,
        pixel_features=meta["pixel_features"], path_depth=pd)


def decode_bounce_types(bt):
    """Decode the int16 bounce-type bitmask into 5 boolean planes
    (reflection, transmission, diffuse, glossy, specular), reference:
    sbmc/datasets.py:676-696.

    Args:
      bt: ``(..., path_depth, ts, ts)`` int16.

    Returns:
      ``(..., 5 * path_depth, ts, ts)`` float32.
    """
    planes = [np.bitwise_and(bt, 1 << b).astype(bool)
              for b in range(5)]
    return np.concatenate(planes, axis=-3).astype(np.float32)
