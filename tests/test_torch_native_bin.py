"""The port's native ``.bin`` decoder (``src/fastbin.cpp`` built by
``sbmc_tpu_torch/data/_native.py``) against the JAX package's
``bin_format.read_tile`` and the port's own pure-Python decoder.

Tolerance: none. Decoding moves bytes, so every array is compared bit for
bit (float arrays as their 32-bit patterns, so NaN payloads count too).
"""

import os

import numpy as np
import pytest

from sbmc_tpu.data import bin_format as jbin
from sbmc_tpu_torch.data import _native, bin_format
from sbmc_tpu_torch.data.synthetic import generate_dataset

_ARRAYS = ("pixel_data", "features", "p", "ld", "bt")
_SCALARS = ("tile_size", "image_width", "image_height", "sample_count",
            "gt_sample_count", "block_x", "block_y", "version",
            "sample_features", "pixel_features", "path_depth")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_tiles_equal(got, want):
    for name in _SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("focus_distance", "aperture_radius", "fov", "scene_radius"):
        assert np.float32(getattr(got, name)).tobytes() == \
            np.float32(getattr(want, name)).tobytes(), name
    for name in _ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _random_tile(rng, ts=24, spp=8):
    """A tile of random records, with NaN, inf and negative values where a
    renderer may write them, and bounce masks over the whole int16 range."""
    pd = bin_format.PATH_DEPTH

    def rand(*shape):
        a = rng.randn(*shape).astype(np.float32) * 10
        a.flat[rng.randint(0, a.size, 5)] = np.nan
        a.flat[rng.randint(0, a.size, 5)] = -np.inf
        return a

    return bin_format.Tile(
        tile_size=ts, image_width=4 * ts, image_height=2 * ts,
        sample_count=spp, gt_sample_count=64, focus_distance=3.5,
        aperture_radius=0.25, fov=45.0, scene_radius=12.0, block_x=ts,
        block_y=0, pixel_data=rand(bin_format.PIXEL_FEATURES, ts, ts),
        features=rand(spp, bin_format.SAMPLE_FEATURES, ts, ts),
        p=rand(spp, 4 * pd, ts, ts), ld=rand(spp, 2 * pd, ts, ts),
        bt=rng.randint(-2 ** 15, 2 ** 15, (spp, pd, ts, ts)).astype(np.int16))


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("bins")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        path = str(root / ("random_%d.bin" % i))
        bin_format.write_tile(path, _random_tile(rng))
        paths.append(path)
    generate_dataset(str(root / "synthetic"), n_scenes=1, ts=16,
                     tiles_per_side=1, spp=8, gt_spp=8, seed=4)
    paths.append(str(root / "synthetic" / "scene_0000" /
                     "tile_0000_0000.bin"))
    return paths


def test_the_native_decoder_builds_here():
    mod = _native.get()
    assert mod is not None and hasattr(mod, "decode_sample_blocks")
    assert os.path.dirname(mod.__file__) == _native.BUILD_DIR


@pytest.mark.parametrize("num_threads", [1, 4])
@pytest.mark.parametrize("spp", [None, 3], ids=["all_spp", "spp3"])
def test_native_read_is_the_jax_read(tiles, spp, num_threads):
    for path in tiles:
        got = bin_format.read_tile(path, spp=spp, num_threads=num_threads)
        want = jbin.read_tile(path, spp=spp, num_threads=num_threads)
        _assert_tiles_equal(got, want)
        assert got.features.shape[0] == (spp or 8)


@pytest.mark.parametrize("spp", [None, 3], ids=["all_spp", "spp3"])
def test_python_fallback_is_the_native_read(tiles, spp, monkeypatch,
                                            caplog):
    """Where the decoder cannot be built, read_tile decodes in Python, gives
    the same arrays, and says so once."""
    native = [bin_format.read_tile(p, spp=spp) for p in tiles]

    def fail():
        raise RuntimeError("no compiler here")
    monkeypatch.setattr(_native, "_build", fail)
    monkeypatch.setattr(_native, "_module", None)
    monkeypatch.setattr(_native, "_tried", False)
    for path, want in zip(tiles, native):
        _assert_tiles_equal(bin_format.read_tile(path, spp=spp), want)
    assert _native.get() is None
    said = [r for r in caplog.records if "decoding in Python" in r.message]
    assert len(said) == 1 and "no compiler here" in said[0].message


def test_too_many_samples_raise(tiles):
    with pytest.raises(ValueError, match="too many samples"):
        bin_format.read_tile(tiles[0], spp=9)
