"""The port's procedural scene generator (``sbmc_tpu_torch.scene_generator``)
on the CPU: the JAX package's own checks (tests/test_pipeline_extras.py
TestSceneGenerator and TestSunCG) run against the port's modules, then the
port against ``sbmc_tpu.scene_generator`` on the same draws.

Scene files are compared byte for byte after
``pbrt_stand_ins.normalise_scene``: each ``uuid4`` id (texture, material
and converted-geometry names, which neither package seeds) becomes
``UUID<n>`` by order of first appearance, and the asset and scene folders
become placeholders.
"""

import json
import os

import numpy as np
import pytest

from sbmc_tpu import scene_generator as jsg
from sbmc_tpu_torch import pbrt_stand_ins
from sbmc_tpu_torch import scene_generator as sg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
#: Seeds of the outdoor parity cases (each with both converters).
SEEDS = (0, 1, 2, 3, 4)


class TestSceneGenerator:
    def test_scene_pbrt_structure(self):
        scn = sg.Scene(renderer=sg.Renderer(spp=4, gt_spp=16, width=64,
                                            height=64))
        scn.camera = sg.Camera(position=[0, 0, 2], fov=45)
        sphere = sg.Sphere(radius=2.0)
        mat = sg.MatteMaterial(id="m0", diffuse=[1, 0, 0])
        sphere.assign_material(mat)
        sg.translate(sphere, [1, 2, 3])
        scn.materials.append(mat)
        scn.shapes.append(sphere)
        scn.lights.append(sg.PointLight(spectrum=[5, 5, 5]))
        out = scn.pbrt()
        assert 'Renderer "rendernet" "integer tilesize" [128] ' \
               '"integer recordedsamples" [4]' in out
        assert 'SurfaceIntegrator "pathrendernet"' in out
        assert '"integer pixelsamples" [16]' in out  # sampler runs gt_spp
        assert 'MakeNamedMaterial "m0" "string type" "matte"' in out
        assert 'NamedMaterial "m0"' in out
        assert "Translate 1 2 3" in out
        assert 'Shape "sphere" "float radius" [2.0]' in out
        assert out.index("WorldBegin") < out.index("LightSource")
        assert out.endswith("WorldEnd\n")

    def test_pathrendernet_requires_gt_spp(self):
        with pytest.raises(RuntimeError):
            sg.Renderer(integrator="pathrendernet", gt_spp=None)
        with pytest.raises(RuntimeError):
            sg.Renderer(integrator="pathrendernet", gt_spp=8, path_depth=3)

    def test_motion_blur_channels(self):
        s = sg.Sphere()
        sg.translate(s, [0, 0, 1])
        sg.translate(s, [1, 0, 0], target="end")
        out = s.pbrt()
        assert "ActiveTransform EndTime" in out
        assert out.index("Translate 0 0 1") < out.index(
            "ActiveTransform EndTime")

    def test_material_roundtrip_params(self):
        m = sg.UberMaterial(id="u", diffuse=[0.1, 0.2, 0.3],
                            glossy_reflection=0.5, roughness=0.7)
        out = m.pbrt()
        assert '"rgb Kd" [0.1 0.2 0.3]' in out
        assert '"rgb Ks" [0.5 0.5 0.5]' in out
        assert '"float roughness" [0.7]' in out

    def test_textured_material_emits_texture(self):
        tex = sg.Imagemap("t0", "spectrum", "wood.tga")
        m = sg.MatteMaterial(id="m", diffuse_texture=tex)
        out = m.pbrt()
        assert out.index('Texture "t0"') < out.index("MakeNamedMaterial")
        assert '"texture Kd" "t0"' in out

    def test_poisson_disc_min_distance(self):
        rng = np.random.RandomState(0)
        pts = np.array(sg.poisson_disc_samples(1.0, 1.0, 0.1, rng=rng))
        assert len(pts) > 20
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        d[np.arange(len(pts)), np.arange(len(pts))] = 1e9
        assert d.min() >= 0.1 - 1e-9

    def test_outdoor_generator_samples_scene(self, tmp_path):
        np.random.seed(3)
        gen = sg.OutdoorSceneGenerator(["env.pfm"], None, ["model.obj"],
                                       "obj2pbrt")
        gen._converter = _FakeConverter(sg)
        ok = False
        for _ in range(10):
            scn = sg.Scene(renderer=sg.Renderer(spp=2, gt_spp=4))
            if gen.sample(scn, str(tmp_path)):
                ok = True
                break
        assert ok
        out = scn.pbrt()
        assert 'LightSource "infinite"' in out
        assert "trianglemesh" in out  # ground plane
        assert scn.camera is not None


class _FakeConverter:
    """Stands in for ObjConverter without running obj2pbrt: one object a
    model (the JAX package's test double, for either package)."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __call__(self, fname, dst):
        return [self.pkg.PBRTObject("geo.pbrt", self.pkg.OBJMaterial(""))]


class _FakeSunCGConverter:
    """One PBRTObject a material group, without obj2pbrt (the JAX package's
    SunCG test double, for either package)."""

    GROUPS = {"lamp1": ["bulbmat", "shademat"]}

    def __init__(self, pkg):
        self.pkg = pkg

    def __call__(self, fname, dst):
        stem = os.path.splitext(os.path.basename(fname))[0]
        return [self.pkg.PBRTObject("%s_%s.pbrt" % (stem, mat),
                                    self.pkg.OBJMaterial(""),
                                    name="%s@%s" % (stem, mat))
                for mat in self.GROUPS.get(stem, ["mat0"])]


IDENTITY = [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]


def _make_suncg_root(tmp_path):
    """The miniature SunCG tree of tests/test_pipeline_extras.py."""
    root = tmp_path / "suncg"
    (root / "house" / "house0").mkdir(parents=True)
    (root / "cameras" / "house0").mkdir(parents=True)
    (root / "room" / "house0").mkdir(parents=True)
    (root / "pbrs" / "util_data").mkdir(parents=True)
    (root / "project_ids.txt").write_text("house0\n")
    house = {"levels": [{"nodes": [
        {"type": "Room", "id": "0_0", "modelId": "rm",
         "nodeIndices": [1, 2, 3],
         "bbox": {"min": [0, 0, 0], "max": [4, 3, 4]}, "valid": 1},
        {"type": "Object", "modelId": "chair1", "valid": 1,
         "transform": IDENTITY},
        {"type": "Object", "modelId": "lamp1", "valid": 1,
         "transform": IDENTITY},
        {"type": "Object", "modelId": "broken", "valid": 0},
    ]}]}
    (root / "house" / "house0" / "house.json").write_text(json.dumps(house))
    for ext in "cfw":
        (root / "room" / "house0" / ("rm%s.obj" % ext)).write_text("")
    cams = root / "cameras" / "house0"
    (cams / "room_camera.txt").write_text(
        "1 1.5 1 0 0 1 0 1 0\n9 9 9 1 0 0 0 1 0\n")
    (cams / "room_camera_good.txt").write_text("1\n\n")
    (cams / "room_camera_name.txt").write_text(
        "house0#0_0_0\nhouse0#0_1_0\n")
    util = root / "pbrs" / "util_data"
    (util / "ModelCategoryMappingNewActive.csv").write_text(
        "model_id,fine_grained_class,coarse_grained_class,nyuv2_40class\n"
        "window1,window,,\n"
        "door1,,door,\n"
        "mirror1,mirror,,\n"
        "plant1,plant,,\n"
        "chair1,chair,furniture,chair\n")
    (util / "light_geometry_compact.txt").write_text(
        "lamp1 1 bulbmat 1 shademat\n")
    return str(root)


def _suncg_gen(pkg, root):
    gen = pkg.SunCGSceneGenerator(["env.pfm"], None, ["prop.obj"],
                                  "obj2pbrt", root)
    gen._converter = _FakeSunCGConverter(pkg)
    gen._suncg._convert = gen._converter
    return gen


class TestSunCG:
    """The legacy SunCG generator against the miniature tree."""

    def test_converter_tables(self, tmp_path):
        c = _suncg_gen(sg, _make_suncg_root(tmp_path))._suncg
        assert c.plist == ["house0"]
        assert "window1" in c.classes["transparent"]
        assert "door1" in c.classes["transparent"]
        assert "mirror1" in c.classes["mirror"]
        assert "plant1" in c.classes["remove"]
        assert c.get_obj_category("window1", "anything") == "transparent"
        assert c.get_obj_category("lamp1", "bulbmat") == "light_bulb"
        assert c.get_obj_category("lamp1", "shademat") == "light_shade"
        assert c.get_obj_category("chair1", "mat0") == "shape"

    def test_cameras_for_scene(self, tmp_path):
        gen = _suncg_gen(sg, _make_suncg_root(tmp_path))
        cams = gen._suncg.cameras_for_scene("house0")
        assert len(cams) == 1  # second camera filtered by the good flags
        assert cams[0]["room"] == "0_0"
        assert cams[0]["camera"][:3] == [1.0, 1.5, 1.0]

    def test_sample_builds_scene(self, tmp_path):
        gen = _suncg_gen(sg, _make_suncg_root(tmp_path))
        np.random.seed(0)
        ok = False
        for _ in range(20):
            scn = sg.Scene(renderer=sg.Renderer(spp=2, gt_spp=4))
            if gen.sample(scn, str(tmp_path / "scene")):
                ok = True
                break
        assert ok
        out = scn.pbrt()
        # The lamp bulb is an area light; its shade is dropped.
        assert 'AreaLightSource "diffuse"' in out
        assert "shademat" not in out
        assert scn.camera is not None
        assert 35 <= scn.camera.fov <= 60
        # Room architecture (c/f/w) and the chair made it in as shapes.
        for stem in ("rmc", "rmf", "rmw", "chair1"):
            assert any(stem in s.pbrt() for s in scn.shapes), stem

    def test_no_light_scene_is_invalid(self, tmp_path):
        """A room with no lamp and no window yields False under every
        window treatment (no light source)."""
        gen = _suncg_gen(sg, _make_suncg_root(tmp_path))
        gen._suncg.light_materials = {"models": [], "bulbs": [],
                                      "shades": []}
        house_f = tmp_path / "suncg" / "house" / "house0" / "house.json"
        house = json.loads(house_f.read_text())
        house["levels"][0]["nodes"][0]["nodeIndices"] = [1]
        house_f.write_text(json.dumps(house))
        np.random.seed(1)
        for _ in range(10):
            scn = sg.Scene(renderer=sg.Renderer(spp=2, gt_spp=4))
            assert not gen.sample(scn, str(tmp_path / "scene"))


# -- the port against the JAX package ----------------------------------------

def _assets(tmp_path):
    lists = pbrt_stand_ins.write_asset_lists(str(tmp_path / "lists"), ASSETS)

    def read(name):
        with open(os.path.join(lists, name)) as f:
            return [ln.strip() for ln in f]
    return read("envmaps.txt"), read("textures.txt"), read("models.txt")


def _outdoor(pkg, seed, assets, converter, dst):
    """An outdoor scene as the datagen CLI draws one (generator built, then
    up to 20 samples, the film's crop drawn at ``pbrt()``); returns its
    normalised text and the normalised names of its geometry files."""
    np.random.seed(seed)
    gen = pkg.OutdoorSceneGenerator(*assets, converter)
    if not isinstance(converter, str):
        gen._converter = converter
    for _ in range(20):
        scn = pkg.Scene(renderer=pkg.Renderer(
            spp=4, gt_spp=16, width=256, height=128, random_crop_w=64,
            random_crop_h=32, tile_size=32))
        if gen.sample(scn, dst):
            break
    else:
        raise AssertionError("no scene in 20 samples")
    text = scn.pbrt()
    geo = os.path.join(dst, "geometry")
    # Each file's own id becomes UUID0: the listing's order follows the
    # ids, which differ between the packages.
    names = sorted(pbrt_stand_ins.normalise_scene(f) for f in (
        os.listdir(geo) if os.path.isdir(geo) else ()))
    return (pbrt_stand_ins.normalise_scene(text, [(ASSETS, "<ASSETS>"),
                                                  (dst, "<SCENE>")]), names)


@pytest.mark.parametrize("seed", SEEDS)
def test_outdoor_scene_matches_jax(tmp_path, seed):
    """The same outdoor scene from both packages, byte for byte after
    normalisation, with the JAX package's converter double."""
    assets = _assets(tmp_path)
    want = _outdoor(jsg, seed, assets, _FakeConverter(jsg),
                    str(tmp_path / "jax"))
    got = _outdoor(sg, seed, assets, _FakeConverter(sg),
                   str(tmp_path / "torch"))
    assert got == want
    assert 'Include "geometry/geo.pbrt"' in got[0]
    assert "cropwindow" in got[0] and "UUID0" in got[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_outdoor_scene_with_obj2pbrt_matches_jax(tmp_path, seed):
    """The same with the obj2pbrt stand-in on the repo's .obj files: both
    packages' ObjConverter run it, and the scene files and converted
    geometry names agree after normalisation."""
    _, obj2pbrt = pbrt_stand_ins.install(str(tmp_path / "bin"))
    assets = _assets(tmp_path)
    want = _outdoor(jsg, seed, assets, obj2pbrt, str(tmp_path / "jax"))
    got = _outdoor(sg, seed, assets, obj2pbrt, str(tmp_path / "torch"))
    assert got == want
    assert any(n.endswith("UUID0_object0000.pbrt") for n in got[1])
    for line in got[0].splitlines():
        if line.startswith("Include"):
            path = line.split('"')[1]
            assert path.startswith("geometry/"), line


def test_obj_material_groups_match_jax(tmp_path):
    """An .obj with two material groups (a quad and a triangle) through
    both packages' ObjConverter and the obj2pbrt stand-in: one geometry
    file a group, named ``<geom>@<mat>``, the same after normalisation."""
    _, obj2pbrt = pbrt_stand_ins.install(str(tmp_path / "bin"))
    src = tmp_path / "src" / "two.obj"
    src.parent.mkdir()
    src.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                   "g body\nusemtl red\nf 1 2 3 4\nusemtl glass\n"
                   "f 1/1 2/2 5/3\n")
    out = []
    for pkg, name in ((jsg, "jax"), (sg, "torch")):
        dst = tmp_path / name
        objs = pkg.ObjConverter(obj2pbrt)(str(src), str(dst))
        assert [(o.geom_name, o.material_group) for o in objs] == [
            ("body", "red"), ("body", "glass")]
        assert sorted(os.listdir(dst)) == sorted(
            ["two.pbrt"] + [os.path.basename(o.path) for o in objs])
        files = [open(os.path.join(dst, o.path)).read() for o in objs]
        out.append(pbrt_stand_ins.normalise_scene("".join(files)))
    assert out[1] == out[0]
    assert '"integer indices" [0 1 2 0 2 3]' in out[1]
    assert '"integer indices" [0 1 2]\n"point P" [0 0 0 1 0 0 0 0 1]' \
        in out[1]


def test_suncg_scene_matches_jax(tmp_path):
    """One SunCG scene from the miniature tree, the same from both
    packages after normalisation."""
    root = _make_suncg_root(tmp_path)
    texts = []
    for pkg, name in ((jsg, "jax"), (sg, "torch")):
        gen = _suncg_gen(pkg, root)
        np.random.seed(0)
        for _ in range(20):
            scn = pkg.Scene(renderer=pkg.Renderer(spp=2, gt_spp=4))
            if gen.sample(scn, str(tmp_path / name)):
                break
        else:
            raise AssertionError("no SunCG scene in 20 samples")
        texts.append(pbrt_stand_ins.normalise_scene(scn.pbrt()))
    assert texts[1] == texts[0]
    assert 'AreaLightSource "diffuse"' in texts[1]


def test_poisson_disc_matches_jax():
    """Bridson's sampler draws the same points from a RandomState and from
    the global stream (its ``rng=np.random`` default)."""
    got = [np.array(pkg.poisson_disc_samples(1.0, 2.0, 0.15,
                                             rng=np.random.RandomState(4)))
           for pkg in (jsg, sg)]
    np.testing.assert_array_equal(got[1], got[0])
    drawn = []
    for pkg in (jsg, sg):
        np.random.seed(9)
        drawn.append(np.array(pkg.poisson_disc_samples(1.0, 1.0, 0.2)))
    np.testing.assert_array_equal(drawn[1], drawn[0])


def test_exports_match_jax():
    """The package exports the JAX package's names, the misspelt
    ``InifiniteLight`` alias included."""
    public = sorted(n for n in dir(jsg) if not n.startswith("_"))
    assert sorted(n for n in dir(sg) if not n.startswith("_")) == public
    assert sg.InifiniteLight is sg.InfiniteLight


def test_materials_and_lights_match_jax():
    """Every material, light, texture and shape class writes the JAX
    package's text for the same arguments."""
    def build(pkg):
        bump = pkg.Imagemap("b", "float", "b.png", scale=0.02,
                            trilinear=True)
        tex = pkg.Checkerboard("c", "spectrum", uscale=2.0)
        objs = [pkg.MatteMaterial(id="m", diffuse_texture=tex,
                                  bump_texture=bump),
                pkg.UberMaterial(id="u", opacity=0.5, index=1.3),
                pkg.MirrorMaterial(), pkg.GlassMaterial(id="g", index=1.4),
                pkg.MetalMaterial(id="x", eta=[0.2, 0.3, 0.4]),
                pkg.PlasticMaterial(id="p", specular=[0.1, 0.1, 0.1]),
                pkg.SubstrateMaterial(id="s", uroughness=0.3),
                pkg.InfiniteLight(spectrum=[2, 2, 2], nsamples=4),
                pkg.InfiniteLight(mapname="env.exr"),
                pkg.AreaLight(pkg.Sphere(0.5), spectrum=[9, 9, 9]),
                pkg.Cylinder(0.2, 3.0), pkg.Plane(4),
                pkg.TriangleMesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0],
                                               [0, 1, 0]]),
                pkg.ExternalGeometry("geometry/a.pbrt")]
        pkg.look_at(objs[-1], [0, 0, 1], [0, 0, 0], [0, 1, 0])
        pkg.transform(objs[-2], IDENTITY, target="start")
        pkg.scale(objs[-3], [1, 2, 3], target="end")
        pkg.rotate(objs[-4], [0, 1, 0], 30)
        cam = pkg.Camera(fov=50, lensradius=0.1, focaldistance=2.0)
        rend = pkg.Renderer(integrator="path", spp=8, filename="a.exr")
        return [o.pbrt() for o in objs] + [cam.pbrt(), rend.pbrt()]
    assert build(sg) == build(jsg)
    with pytest.raises(ValueError, match="unknown xform target"):
        sg.translate(sg.Sphere(), [0, 0, 0], target="middle")
