"""The port's host-side IO against the JAX package's: ``.bin`` reading,
synthetic data generation, tiling and EXR output. All of it is numpy data
movement, so the comparisons are exact (byte- or array-equal)."""

import os

import numpy as np
import pytest

from sbmc_tpu.data import FullImagesDataset as JFullImagesDataset
from sbmc_tpu.data import bin_format as jbin
from sbmc_tpu.data.synthetic import generate_dataset as jgenerate
from sbmc_tpu.parallel import tiles as jtiles
from sbmc_tpu.utils import exr as jexr
from sbmc_tpu_torch.data import bin_format, lz4f
from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.parallel import tiles
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.image import write_png


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jaxdata"))
    jgenerate(root, n_scenes=2, ts=16, tiles_per_side=2, spp=3, gt_spp=4,
              seed=5)
    return root


def test_synthetic_data_is_byte_identical(jax_data, tmp_path):
    generate_dataset(str(tmp_path), n_scenes=2, ts=16, tiles_per_side=2,
                     spp=3, gt_spp=4, seed=5)
    ours, theirs = _files(str(tmp_path)), _files(jax_data)
    assert sorted(ours) == sorted(theirs) and len(ours) == 8
    for name in ours:
        assert ours[name] == theirs[name], name


def test_read_tile_matches_jax(jax_data):
    path = os.path.join(jax_data, "scene_0001", "tile_0001_0000.bin")
    for spp in (None, 2):
        a = bin_format.read_tile(path, spp=spp)
        b = jbin.read_tile(path, spp=spp)
        for field in ("pixel_data", "features", "p", "ld", "bt"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        for field in ("block_x", "block_y", "fov", "aperture_radius",
                      "focus_distance", "scene_radius", "sample_count"):
            assert getattr(a, field) == getattr(b, field)


@pytest.mark.parametrize("spp", [3, 2])
def test_full_images_dataset_matches_jax(jax_data, spp):
    ours = FullImagesDataset(jax_data, spp=spp)
    theirs = JFullImagesDataset(jax_data, spp=spp)
    assert len(ours) == len(theirs) == 2
    assert ours.num_features == theirs.num_features == 93
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_dataset_errors(jax_data, tmp_path):
    with pytest.raises(RuntimeError, match="too many"):
        TilesDataset(jax_data, spp=4)
    for mode in ("kpcn", "raw"):  # taken; g-buffer on, the extras off
        data = TilesDataset(jax_data, mode=mode, load_gbuffer=False)
        assert data.mode == mode and data.load_gbuffer
        assert not (data.load_coords or data.load_p or data.load_ld
                    or data.load_bt)
    with pytest.raises(RuntimeError, match="Unknown dataset loading mode"):
        TilesDataset(jax_data, mode="sbmc2")
    with pytest.raises(RuntimeError, match="Empty"):
        TilesDataset(str(tmp_path))


def test_bin_roundtrip_and_lz4(tmp_path):
    payload = np.random.RandomState(0).bytes(5000) + bytes(20000)
    assert lz4f.decompress(lz4f.compress(payload)) == payload
    rng = np.random.RandomState(1)
    ts, spp, pd = 8, 2, bin_format.PATH_DEPTH
    tile = bin_format.Tile(
        tile_size=ts, image_width=16, image_height=8, sample_count=spp,
        gt_sample_count=4, focus_distance=2.0, aperture_radius=0.1,
        fov=0.4, scene_radius=12.0, block_x=8, block_y=0,
        pixel_data=rng.rand(30, ts, ts).astype(np.float32),
        features=rng.rand(spp, 27, ts, ts).astype(np.float32),
        p=rng.rand(spp, 4 * pd, ts, ts).astype(np.float32),
        ld=rng.rand(spp, 2 * pd, ts, ts).astype(np.float32),
        bt=rng.randint(0, 32, (spp, pd, ts, ts)).astype(np.int16))
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    bin_format.write_tile(a, tile)
    jbin.write_tile(b, tile)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = jbin.read_tile(a)
    np.testing.assert_array_equal(back.bt, tile.bt)
    np.testing.assert_array_equal(
        bin_format.decode_bounce_types(tile.bt),
        jbin.decode_bounce_types(tile.bt))


def _batch(rng, h, w, spp=2):
    return {"radiance": rng.rand(1, spp, 3, h, w).astype(np.float32),
            "features": rng.rand(1, spp, 5, h, w).astype(np.float32),
            "global_features": rng.rand(1, 3, 1, 1).astype(np.float32),
            "spp": np.full((1, 1, 1, 1), spp, np.int32)}


@pytest.mark.parametrize("tile,pad,hw", [(32, 8, (70, 45)),
                                         ((24, 40), (6, 8), (50, 90)),
                                         (64, 16, (40, 30))])
def test_uniform_tiles_match_jax(tile, pad, hw):
    batch = _batch(np.random.RandomState(2), *hw)
    a, ia = tiles.split_tiles_uniform(batch, tile=tile, pad=pad)
    b, ib = jtiles.split_tiles_uniform(batch, tile=tile, pad=pad)
    assert ia == ib and sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    crop = 2
    out = a["radiance"][:, 0, :, crop:-crop, crop:-crop]
    np.testing.assert_array_equal(tiles.merge_tiles_uniform(out, ia),
                                  jtiles.merge_tiles_uniform(out, ib))


@pytest.mark.parametrize("max_sz,pad,hw", [(32, 8, (70, 45)),
                                           (100, 8, (40, 30))])
def test_ragged_tiles_match_jax(max_sz, pad, hw):
    batch = _batch(np.random.RandomState(3), *hw)
    a = tiles.split_tiles(batch, max_sz=max_sz, pad=pad)
    b = jtiles.split_tiles(batch, max_sz=max_sz, pad=pad)
    assert len(a) == len(b)
    merged_a, merged_b = [], []
    for (ta, *ga), (tb, *gb) in zip(a, b):
        assert ga == gb and sorted(ta) == sorted(tb)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k])
        out = ta["radiance"][:, 0, :, 2:-2, 2:-2]
        merged_a.append((tiles.pad_back(ta, out), *ga))
        merged_b.append((jtiles.pad_back(tb, out), *gb))
    canvas = np.zeros((1, 3) + hw, np.float32)
    np.testing.assert_array_equal(
        tiles.merge_tiles(canvas.copy(), merged_a),
        jtiles.merge_tiles(canvas.copy(), merged_b))


@pytest.mark.parametrize("pixel_type,compression",
                         [("half", "zip"), ("float", "none"),
                          ("half", "zips")])
def test_exr_matches_jax(tmp_path, pixel_type, compression):
    img = (np.random.RandomState(4).rand(37, 21, 3) * 4).astype(np.float32)
    a, b = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    exr.write(a, img, pixel_type=pixel_type, compression=compression)
    jexr.write(b, img, pixel_type=pixel_type, compression=compression)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = exr.read(a)
    np.testing.assert_array_equal(back, jexr.read(b))
    want = img.astype(np.float16).astype(np.float32) \
        if pixel_type == "half" else img
    np.testing.assert_array_equal(back, want)


def test_png_reads_back(tmp_path):
    """The port writes its PNG preview itself (the JAX script uses
    imageio); imageio reads it back unchanged."""
    import imageio.v2 as imageio
    img = np.random.RandomState(6).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    with pytest.raises(ValueError):
        write_png(path, img[..., :2])
