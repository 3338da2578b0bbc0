"""The port's PBRT drivers (``sbmc_tpu_torch.rendering``, ``python -m
sbmc_tpu_torch.render_exr`` and ``render_samples``) on the CPU: the JAX
package's checks (tests/test_rendering.py) against the port's module with
the same mock ``pbrt``, then both packages' CLIs on one scene with the
``pbrt`` stand-in of ``sbmc_tpu_torch.pbrt_stand_ins`` (a test double: the
repo does not hold the patched PBRTv2). The stand-in seeds its pixels from
the scene file, so the same scene gives the same bytes.
"""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from sbmc_tpu_torch import pbrt_stand_ins, render_exr, render_samples
from sbmc_tpu_torch import scene_generator as sg
from sbmc_tpu_torch.data import bin_format
from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.rendering import (PBRTRenderer, PBRTRenderingParser,
                                      PBRTSamplesRenderer,
                                      SamplesRenderingParser)
from sbmc_tpu_torch.utils import exr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
#: Seconds a CLI subprocess may take (the JAX scripts import jax).
CLI_TIMEOUT = 300


def _mock_pbrt(tmp_path, mode):
    """A fake pbrt: writes scene.exr or a .bin tile into the cwd."""
    exe = tmp_path / "pbrt"
    if mode == "exr":
        body = "#!/bin/bash\ntouch scene.exr\n"
    else:
        body = "#!/bin/bash\ntouch 0000_0000.bin\n"
    exe.write_text(body)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe)


def _scene(tmp_path):
    sdir = tmp_path / "myscene"
    sdir.mkdir()
    scene = sdir / "scene.pbrt"
    scene.write_text('WorldBegin\nShape "sphere"\nWorldEnd\n')
    (sdir / "asset.tga").write_text("x")  # an asset to symlink
    return str(scene)


class TestExrDriver:
    def test_renders_and_moves_output(self, tmp_path):
        exe = _mock_pbrt(tmp_path, "exr")
        scene = _scene(tmp_path)
        out = str(tmp_path / "out" / "result.exr")
        args = PBRTRenderingParser().parse_args(
            [exe, scene, out, "--tmp_dir", str(tmp_path / "work"),
             "--spp", "4", "--width", "64", "--height", "64"])
        # header is prepended with the plain path integrator
        assert 'SurfaceIntegrator "path"' in args.scene_desc
        assert '"integer pixelsamples" [4]' in args.scene_desc
        assert 'WorldBegin' in args.scene_desc
        PBRTRenderer(args).render()
        assert os.path.exists(out)

    def test_requires_exr_output(self, tmp_path):
        exe = _mock_pbrt(tmp_path, "exr")
        scene = _scene(tmp_path)
        with pytest.raises(RuntimeError):
            PBRTRenderingParser().parse_args(
                [exe, scene, str(tmp_path / "out.png")])

    def test_missing_scene_raises(self, tmp_path):
        exe = _mock_pbrt(tmp_path, "exr")
        with pytest.raises(RuntimeError):
            PBRTRenderingParser().parse_args(
                [exe, str(tmp_path / "nope.pbrt"), str(tmp_path / "o.exr")])


class TestSamplesDriver:
    def test_renders_bins_to_folder(self, tmp_path):
        exe = _mock_pbrt(tmp_path, "bin")
        scene = _scene(tmp_path)
        out = str(tmp_path / "bins")
        args = SamplesRenderingParser().parse_args(
            [exe, scene, out, "--tmp_dir", str(tmp_path / "work"),
             "--spp", "4", "--gt_spp", "32"])
        # the instrumented renderer header is emitted
        assert 'Renderer "rendernet"' in args.scene_desc
        assert '"integer recordedsamples" [4]' in args.scene_desc
        assert '"integer pixelsamples" [32]' in args.scene_desc
        PBRTSamplesRenderer(args).render()
        assert any(f.endswith(".bin") for f in os.listdir(out))


def _stand_in_scene(tmp_path, renderer=None):
    """A scene folder as the generator writes one: a converted .obj under
    ``geometry/``, an image texture, an environment map and a camera; with
    ``renderer`` its render block leads the file."""
    _, obj2pbrt = pbrt_stand_ins.install(str(tmp_path / "bin"))
    sdir = tmp_path / "scene"
    objs = sg.ObjConverter(obj2pbrt)(os.path.join(ASSETS, "objs",
                                                  "l_bracket.obj"),
                                     str(sdir / "geometry"))
    scn = sg.Scene(renderer=renderer, camera=sg.Camera(
        position=[0, 1, 4], fov=40, lensradius=0.02, focaldistance=4.0))
    tex = sg.Imagemap("t0", "spectrum",
                      os.path.join(ASSETS, "textures", "dots_0.png"))
    mat = sg.MatteMaterial(id=objs[0].material.id, diffuse_texture=tex)
    scn.materials.append(mat)
    geom = sg.ExternalGeometry(os.path.join("geometry", objs[0].path))
    scn.shapes.append(geom)
    scn.lights.append(sg.InfiniteLight(
        mapname=os.path.join(ASSETS, "envmaps", "day_0.exr")))
    path = sdir / "scene.pbrt"
    path.write_text(scn.pbrt())
    return str(path), str(tmp_path / "bin" / "pbrt")


def _run(argv, **env):
    proc = subprocess.run([sys.executable] + argv, cwd=ROOT,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _files(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder))}


def test_render_samples_cli_matches_jax(tmp_path):
    """``python -m sbmc_tpu_torch.render_samples`` and
    ``scripts/render_samples.py`` with the pbrt stand-in: the same tiles,
    byte for byte, in the output folder. Both drivers leave
    ``--tile_size`` out of the header they write, so the tiles have the
    renderer's default of 128 pixels. The port's CLI removes its temporary
    folder (the JAX script's renderer is a module global, whose
    ``__del__`` runs at interpreter exit, when it may find ``os`` gone)."""
    scene, pbrt = _stand_in_scene(tmp_path)
    args = ["--spp", "4", "--gt_spp", "8", "--tile_size", "16", "--width",
            "128", "--height", "256"]
    outs = {}
    for name, cli in (("jax", ["scripts/render_samples.py"]),
                      ("torch", ["-m", "sbmc_tpu_torch.render_samples"])):
        outs[name] = str(tmp_path / name)
        work = str(tmp_path / ("work_" + name))
        _run(cli + [pbrt, scene, outs[name], "--tmp_dir", work] + args,
             JAX_PLATFORMS="cpu")
    assert not os.path.exists(work)
    got, want = _files(outs["torch"]), _files(outs["jax"])
    assert sorted(got) == ["0000_0000.bin", "0001_0000.bin"]
    assert got == want
    tile = bin_format.read_tile(os.path.join(outs["torch"], "0001_0000.bin"))
    assert tile.features.shape == (4, 27, 128, 128)
    assert (tile.gt_sample_count, tile.image_width, tile.image_height,
            tile.block_x, tile.block_y) == (8, 128, 256, 0, 128)
    assert tile.aperture_radius == pytest.approx(0.02)
    assert tile.focus_distance == pytest.approx(4.0)
    assert np.isfinite(tile.features).all()


def test_render_exr_cli_matches_jax(tmp_path):
    """``python -m sbmc_tpu_torch.render_exr`` and
    ``scripts/render_exr.py`` with the pbrt stand-in write the same EXR."""
    scene, pbrt = _stand_in_scene(tmp_path)
    outs = {}
    for name, cli in (("jax", ["scripts/render_exr.py"]),
                      ("torch", ["-m", "sbmc_tpu_torch.render_exr"])):
        outs[name] = str(tmp_path / name / "frame.exr")
        _run(cli + [pbrt, scene, outs[name], "--tmp_dir",
                    str(tmp_path / ("work_" + name)), "--width", "40",
                    "--height", "24"], JAX_PLATFORMS="cpu")
    with open(outs["torch"], "rb") as f, open(outs["jax"], "rb") as g:
        assert f.read() == g.read()
    img = exr.read(outs["torch"])
    assert img.shape == (24, 40, 3) and np.isfinite(img).all()


def test_scene_render_block_wins(tmp_path):
    """On a generated scene, whose own render block follows the header
    ``render_samples`` writes, the stand-in renders the scene's crop window
    and sample counts, as PBRT keeps the last statement; the tiles assemble
    into the crop."""
    np.random.seed(5)
    scene, pbrt = _stand_in_scene(tmp_path, sg.Renderer(
        spp=2, gt_spp=4, width=64, height=64, random_crop_w=32,
        random_crop_h=32, tile_size=16))
    out = tmp_path / "frames" / "scene_0"
    render_samples.main([pbrt, scene, str(out), "--tmp_dir",
                         str(tmp_path / "work")])
    assert sorted(os.listdir(out)) == ["0000_0000.bin", "0000_0001.bin",
                                       "0001_0000.bin", "0001_0001.bin"]
    frame = FullImagesDataset(str(out.parent), spp=2)[0]
    assert frame["low_spp"].shape == (3, 32, 32)
    assert np.isfinite(frame["target_image"]).all()
    body = tmp_path / "scene" / "body.pbrt"
    body.write_text(pbrt_stand_ins.scene_body(open(scene).read()))
    args = render_exr.main([pbrt, str(body), str(tmp_path / "b.exr"),
                            "--width", "20", "--height", "10", "--tmp_dir",
                            str(tmp_path / "work2")])
    assert exr.read(args.output).shape == (10, 20, 3)


def test_stand_in_fails_on_missing_file(tmp_path):
    """The stand-in fails as pbrt does when an included file is missing,
    and ``render_samples`` raises."""
    scene, pbrt = _stand_in_scene(tmp_path)
    text = open(scene).read().replace("geometry/", "gone/")
    with open(scene, "w") as f:
        f.write(text)
    with pytest.raises(subprocess.CalledProcessError):
        render_samples.main([pbrt, scene, str(tmp_path / "o"), "--tmp_dir",
                             str(tmp_path / "work")])
