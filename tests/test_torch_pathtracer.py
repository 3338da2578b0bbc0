"""The port's wavefront renderer (``sbmc_tpu_torch.render.pathtracer``, on
the CPU: the triangle and threefry kernels' plain versions) against the JAX
renderer, at ts 16, spp 2, gt 4.

Tolerance. A sample's record agrees when every channel is within 1e-3 +
1e-3 |JAX|. The random draws are bit-exact, so the camera coordinates
(dx, dy, lens, time) agree on every sample. Everything else goes through
sin, cos, pow, acos, atan2, erfinv and float32 products that XLA's CPU
backend contracts into fused multiply-adds, so a path can leave a surface
an ulp apart and flip at an edge: the g-buffer, the pdfs, the light
directions and the bounce types may disagree on at most GEO_SHARE of the
samples (measured: at most 0.4% over six random scenes).

The procedural value-noise texture is the exception: its lattice hash
``|sin(x) * 43758.5453| % 1`` maps an ulp of its argument to an arbitrary
value, and XLA contracts that argument's products where it fuses them. So
the scenes are held to GEO_SHARE on every record with their noise textures
replaced by stripes, and with them only their geometry is; then radiance
and albedo may disagree on up to TEX_SHARE of the samples (measured: 24%
on a scene whose largest surfaces carry noise) and the tile's mean radiance
within 10%. A pixel of the ground-truth statistics averages the GT
passes and differs where any of them does: up to PIX_TEX_SHARE (measured:
41% on the same scene).

In the KPCN convention the pdfs are written raw; they hold ``cos ** n`` with
Phong exponents n up to 800, which multiply an ulp of the cosine by n, so
they are compared in the log scale the default convention writes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sbmc_tpu.render import assets as jassets
from sbmc_tpu.render import pathtracer as jpt
from sbmc_tpu_torch.data.datasets import TilesDataset
from sbmc_tpu_torch.data import bin_format
from sbmc_tpu_torch.render import assets, pathtracer, prng, scene

GEO_SHARE = 0.02
TEX_SHARE = 0.30
PIX_TEX_SHARE = 0.50
TS, SPP, GT = 16, 2, 4
POOL_DIRS = ("assets/objs", "assets/textures", "assets/envmaps")

#: feature index ranges of the 27 sample features
CAMERA = slice(0, 5)
RADIANCE = slice(5, 11)
GEOMETRY = slice(11, 21)
ALBEDO = slice(21, 27)


def _pools(module):
    return dict(obj_pool=module.ObjPool(POOL_DIRS[0]),
                tex_pool=module.TexturePool(POOL_DIRS[1]),
                env_pool=module.EnvmapPool(POOL_DIRS[2]))


def _scenes(seed, noise, pools=True):
    """The same random scene in both packages; without ``noise`` its
    value-noise textures become stripes."""
    out = []
    for sc_mod, pool_mod in ((scene, assets), (jpt, jassets)):
        sc = sc_mod.random_tracer_scene(np.random.RandomState(seed),
                                        **(_pools(pool_mod) if pools else {}))
        if not noise:
            sc.tex_kind = np.where(sc.tex_kind == scene.TEX_NOISE,
                                   scene.TEX_STRIPES, sc.tex_kind)
            if sc.ground_tex_kind == scene.TEX_NOISE:
                sc.ground_tex_kind = scene.TEX_STRIPES
        out.append(sc)
    return out


def _share(got, want, axis):
    """Share of samples with a channel beyond 1e-3 + 1e-3 |want| (channels
    on ``axis``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)
    return bad.any(axis).mean()


def _render_both(seed, noise, kpcn_mode=False):
    sc_t, sc_j = _scenes(seed, noise)
    got = pathtracer.render_tile_wavefront(
        sc_t, prng.PRNGKey(seed), ts=TS, spp=SPP, gt_spp=GT, device="cpu",
        kpcn_mode=kpcn_mode)
    want = jpt.render_tile_wavefront(sc_j, jax.random.PRNGKey(seed), ts=TS,
                                     spp=SPP, gt_spp=GT, kpcn_mode=kpcn_mode)
    return got, want


def _log_p(p):
    return np.log(np.minimum(p, 1e12) + 1e-8) / 30.0


def _check_geometry(got, want, kpcn_mode=False):
    np.testing.assert_allclose(got.features[:, CAMERA],
                               want.features[:, CAMERA], rtol=1e-6,
                               atol=1e-7)
    assert _share(got.features[:, GEOMETRY], want.features[:, GEOMETRY],
                  1) <= GEO_SHARE
    assert _share(got.pixel_data[9:15], want.pixel_data[9:15],
                  0) <= GEO_SHARE
    for name in ("p", "ld", "bt"):
        g, w = getattr(got, name), getattr(want, name)
        if name == "p" and kpcn_mode:
            g, w = _log_p(g), _log_p(w)
        assert _share(g, w, 1) <= GEO_SHARE, name
    for name in ("tile_size", "image_width", "image_height", "sample_count",
                 "gt_sample_count", "block_x", "block_y"):
        assert getattr(got, name) == getattr(want, name)
    for name in ("focus_distance", "aperture_radius", "fov", "scene_radius"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-7)


@pytest.mark.parametrize("kpcn_mode", [False, True])
def test_tile_matches_jax_without_noise(kpcn_mode):
    """Every record of the .bin surface (meshes, image textures and an
    envmap in play), in both recording conventions."""
    got, want = _render_both(1, noise=False, kpcn_mode=kpcn_mode)
    _check_geometry(got, want, kpcn_mode)
    assert _share(got.features, want.features, 1) <= GEO_SHARE
    assert _share(got.pixel_data, want.pixel_data, 0) <= GEO_SHARE


def test_tile_matches_jax_with_noise():
    got, want = _render_both(0, noise=True)
    _check_geometry(got, want)
    for part in (RADIANCE, ALBEDO):
        assert _share(got.features[:, part], want.features[:, part],
                      1) <= TEX_SHARE
    assert _share(got.pixel_data, want.pixel_data, 0) <= PIX_TEX_SHARE
    mean_got = got.features[:, RADIANCE].mean()
    mean_want = want.features[:, RADIANCE].mean()
    assert abs(mean_got - mean_want) <= 0.1 * mean_want


def test_render_pass_matches_jax():
    """One pass, record by record (the tile's assembly aside)."""
    sc_t, sc_j = _scenes(3, noise=False)
    key = prng.fold_in(prng.PRNGKey(9), 1)
    got = pathtracer.render_pass(pathtracer.prepare_scene(sc_t, "cpu"), key,
                                 TS, 16, 0, 32, 16)
    want = jax.jit(jpt.render_pass, static_argnums=(2, 5, 6))(
        sc_j.as_jax(), jax.numpy.asarray(key), TS, 16, 0, 32, 16)
    assert set(got) == set(want)
    for name in ("dx", "dy", "t", "lens_u", "lens_v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        axis = tuple(range(1, g.ndim)) if g.ndim > 1 else None
        share = (_share(g, w, axis) if axis
                 else (np.abs(g - w) > 1e-3 + 1e-3 * np.abs(w)).mean())
        assert share <= GEO_SHARE, (name, share)


def _tiles_equal(a, b):
    for name in ("pixel_data", "features", "p", "ld", "bt"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.block_x, a.block_y) == (b.block_x, b.block_y)


def test_tile_batches_match_serial_tiles():
    """Three tiles a wavefront (a ragged last chunk, coordinates out of
    raster order) record what each tile records alone."""
    sc, _ = _scenes(4, noise=True, pools=False)
    base = prng.PRNGKey(7)
    coords = [(3, TS, TS), (0, 0, 0), (2, 0, TS), (1, TS, 0)]
    batched = pathtracer.render_tiles_wavefront(
        sc, base, coords, ts=TS, spp=SPP, gt_spp=GT, image_width=32,
        image_height=32, tile_batch=3, device="cpu")
    assert len(batched) == 4
    for (i, bx, by), tile in zip(coords, batched):
        alone = pathtracer.render_tile_wavefront(
            sc, prng.fold_in(base, i), ts=TS, spp=SPP, gt_spp=GT, block_x=bx,
            block_y=by, image_width=32, image_height=32, device="cpu")
        _tiles_equal(tile, alone)


def test_env_knob_overrides_tile_batch(monkeypatch):
    sc, _ = _scenes(4, noise=True, pools=False)
    coords = [(0, 0, 0), (1, TS, 0)]
    kw = dict(ts=TS, spp=1, gt_spp=1, image_width=32, image_height=16,
              device="cpu")
    monkeypatch.setenv("SBMC_TILE_BATCH", "2")
    calls = []
    plain = pathtracer._render
    monkeypatch.setattr(pathtracer, "_render",
                        lambda *a, **k: calls.append(a[2]) or plain(*a, **k))
    tiles = pathtracer.render_tiles_wavefront(sc, prng.PRNGKey(3), coords,
                                              tile_batch=64, **kw)
    assert len(tiles) == 2 and len(calls) == 1 and len(calls[0]) == 2


def test_dataset_writer_batches_tiles_by_env_knob(monkeypatch, tmp_path):
    """The dataset writer traces SBMC_TILE_BATCH tiles a wavefront and
    writes each tile of every wavefront."""
    monkeypatch.setenv("SBMC_TILE_BATCH", "3")
    calls = []
    plain = pathtracer._render
    monkeypatch.setattr(pathtracer, "_render",
                        lambda *a, **k: calls.append(a[2]) or plain(*a, **k))
    pathtracer.generate_wavefront_dataset(
        str(tmp_path), n_scenes=1, ts=8, tiles_per_side=2, spp=1, gt_spp=1,
        seed=0, device="cpu")
    assert [len(c) for c in calls] == [3, 1]
    names = sorted(os.listdir(tmp_path / "scene_00000"))
    assert names == ["tile_%04d_%04d.bin" % (y, x)
                     for y in range(2) for x in range(2)]


def test_pass_batches_match_serial_passes(monkeypatch):
    """Passes traced one at a time give the records of the default batch
    (all of a tile's passes in one wavefront here)."""
    sc, _ = _scenes(5, noise=True)
    kw = dict(ts=TS, spp=3, gt_spp=5, block_x=TS, image_width=32,
              image_height=16, device="cpu")
    together = pathtracer.render_tile_wavefront(sc, prng.PRNGKey(2), **kw)
    monkeypatch.setattr(pathtracer, "_WAVEFRONT_RAYS", 2 * TS * TS)
    pairs = pathtracer.render_tile_wavefront(sc, prng.PRNGKey(2), **kw)
    monkeypatch.setattr(pathtracer, "_WAVEFRONT_RAYS", TS * TS)
    alone = pathtracer.render_tile_wavefront(sc, prng.PRNGKey(2), **kw)
    _tiles_equal(together, alone)
    _tiles_equal(pairs, alone)


def test_card_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc, _ = _scenes(0, noise=True, pools=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pathtracer.render_tile_wavefront(sc, prng.PRNGKey(0), ts=TS, spp=1,
                                         gt_spp=1)


# The physical checks of tests/test_pathtracer.py::TestWavefront, on the
# port.

def _simple_scene(mirror=0.0, aperture=0.0, motion=0.0):
    return scene.TracerScene(
        centers=np.array([[0.0, 1.0, 5.0]]), radii=np.array([1.0]),
        albedos=np.array([[0.8, 0.2, 0.2]]), mirror=np.array([mirror]),
        roughness=np.array([1.0]), motion=np.array([[motion, 0.0, 0.0]]),
        ground_albedo=np.array([0.5, 0.5, 0.5]),
        light_pos=np.array([0.0, 6.0, 3.0]), light_radius=0.5,
        light_emission=np.array([60.0, 60.0, 60.0]),
        sky=np.array([0.1, 0.1, 0.1]), fov=45.0, aperture=aperture,
        focus_distance=5.0)


def _tile(sc, seed, ts, spp, gt_spp):
    return pathtracer.render_tile_wavefront(sc, prng.PRNGKey(seed), ts=ts,
                                            spp=spp, gt_spp=gt_spp,
                                            device="cpu")


class TestWavefrontPhysics:
    def test_tile_is_valid_and_roundtrips(self, tmp_path):
        tile = _tile(_simple_scene(), 0, 16, 2, 4)
        assert tile.features.shape == (2, 27, 16, 16)
        for arr in [tile.features, tile.pixel_data, tile.p, tile.ld]:
            assert np.isfinite(arr).all()
        assert (tile.features[:, 5:11] >= 0).all()  # radiance positive
        path = str(tmp_path / "t.bin")
        bin_format.write_tile(path, tile)
        back = bin_format.read_tile(path)
        np.testing.assert_array_equal(back.features, tile.features)

    def test_sphere_visible_in_gbuffer(self):
        tile = _tile(_simple_scene(), 1, 24, 1, 1)
        assert tile.features[0, 20].max() == 1.0  # something is hit
        albedo_r, albedo_g = tile.features[0, 21], tile.features[0, 22]
        c = albedo_r.shape[0] // 2
        assert albedo_r[c, c] > albedo_g[c, c]

    def test_mirror_sets_specular_flags(self):
        bt0 = _tile(_simple_scene(mirror=1.0), 2, 24, 1, 1).bt[0, 0]
        assert (bt0 == (scene.BT_REFLECTION | scene.BT_SPECULAR)).any()
        assert (bt0 == (scene.BT_REFLECTION | scene.BT_DIFFUSE)).any()

    def test_diffuse_flags_without_mirror(self):
        flags = set(np.unique(_tile(_simple_scene(), 3, 16, 1,
                                    1).bt[0, 0]).tolist())
        assert flags <= {0, scene.BT_REFLECTION | scene.BT_DIFFUSE}

    def test_gt_correlates_with_samples(self):
        sc = scene.random_tracer_scene(np.random.RandomState(0))
        tile = _tile(sc, 4, 32, 4, 16)
        gt = tile.pixel_data[:3] + tile.pixel_data[3:6]
        low = (tile.features[:, 5:8] + tile.features[:, 8:11]).mean(0)
        assert np.corrcoef(gt.ravel(), low.ravel())[0, 1] > 0.5

    def test_motion_blur_spreads_samples(self):
        def hit_variance(sc):
            return _tile(sc, 5, 24, 4, 1).features[:, 20].std(axis=0).mean()

        assert (hit_variance(_simple_scene(motion=3.0))
                > hit_variance(_simple_scene(motion=0.0)) + 1e-4)

    def test_glossy_flags(self):
        sc = _simple_scene()
        sc.roughness = np.array([0.2])
        flags = set(np.unique(_tile(sc, 6, 24, 1, 1).bt[0, 0]).tolist())
        assert (scene.BT_REFLECTION | scene.BT_GLOSSY) in flags

    @pytest.mark.parametrize("tiles_y,side", [(None, 2), (2, 3)])
    def test_loads_through_dataset(self, tmp_path, tiles_y, side):
        pathtracer.generate_wavefront_dataset(
            str(tmp_path), n_scenes=1, ts=16, tiles_per_side=side,
            tiles_y=tiles_y, spp=2, gt_spp=2, seed=0, device="cpu")
        d = TilesDataset(str(tmp_path), spp=2)
        assert len(d) == side * (tiles_y or side)
        assert d.image_width == 16 * side
        assert d.image_height == 16 * (tiles_y or side)
        item = d[0]
        assert item["features"].shape == (2, 93, 16, 16)
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                assert np.isfinite(v).all(), k
