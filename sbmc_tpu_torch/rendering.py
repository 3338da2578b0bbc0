"""Drivers for the external PBRT renderer (reference: sbmc/rendering.py).

These prepend a renderer header (from :class:`sbmc_tpu_torch.scene_generator.
Renderer`) to a .pbrt scene, run the ``pbrt`` executable in a temp dir with
the scene's assets symlinked, and collect ``.exr`` images or per-sample
``.bin`` tiles. The renderer itself is an external binary (the reference's
patched PBRTv2) that the repo does not hold — it is data-generation
tooling, not part of the GPU runtime.

A copy of ``sbmc_tpu/rendering.py`` (the port imports nothing of the JAX
package); ``python -m sbmc_tpu_torch.render_exr`` and ``python -m
sbmc_tpu_torch.render_samples`` are its entry points.
"""

import argparse
import os
import shutil
import subprocess
import tempfile

from sbmc_tpu_torch.scene_generator import Renderer
from sbmc_tpu_torch.utils.logging import get_logger, set_logger

LOG = get_logger(__name__)

__all__ = ["BaseRenderingParser", "PBRTRenderingParser",
           "SamplesRenderingParser", "PBRTRenderer", "PBRTSamplesRenderer"]


class BaseRenderingParser(argparse.ArgumentParser):
    """Shared CLI for the rendering drivers."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument("pbrt_exe", help="path to the `pbrt` executable.")
        self.add_argument("scene", help="path to the .pbrt scene file.")
        self.add_argument("output", help="output path.")
        self.add_argument("--tmp_dir", default=None,
                          help="temporary working directory.")
        self.add_argument("--spp", type=int, default=8,
                          help="number of samples to save.")
        self.add_argument("--tile_size", type=int, default=128,
                          help="size of the rendering tiles (pixels).")
        self.add_argument("--path_depth", type=int, default=5,
                          help="number of bounces for the pathtracer.")
        self.add_argument("--pixel_filter", default="box", choices=["box"])
        self.add_argument("--width", type=int, default=512)
        self.add_argument("--height", type=int, default=512)
        self.add_argument("--verbose", action="store_true", default=False)

    def parse_args(self, *a, **kw):
        args = super().parse_args(*a, **kw)
        args.scene = os.path.abspath(args.scene)
        args.pbrt_exe = os.path.abspath(args.pbrt_exe)
        args.output = os.path.abspath(args.output)
        if args.tmp_dir is None:
            args.tmp_dir = tempfile.mkdtemp()
        args.tmp_dir = os.path.abspath(args.tmp_dir)

        if not os.path.exists(args.scene):
            raise RuntimeError("PBRT scene %s does not exist" % args.scene)
        if not os.path.exists(args.pbrt_exe):
            raise RuntimeError("PBRT executable not found at %s"
                               % args.pbrt_exe)

        args.scene_root = os.path.dirname(args.scene)
        args.scene_name = os.path.splitext(
            os.path.basename(args.scene_root))[0]
        with open(args.scene) as fid:
            args.scene_desc = self._add_scene_header(fid.read(), args)
        args.scene_path = os.path.join(args.tmp_dir, "scene.pbrt")
        return args

    def _add_scene_header(self, scene_desc, args):
        return scene_desc


class PBRTRenderingParser(BaseRenderingParser):
    """CLI for plain image (.exr) rendering."""

    def _add_scene_header(self, scene_desc, args):
        if os.path.splitext(args.output)[-1] != ".exr":
            raise RuntimeError("Output should be the path to a .exr image.")
        renderer = Renderer(path_depth=args.path_depth, spp=args.spp,
                            pixel_filter=args.pixel_filter, width=args.width,
                            height=args.height, integrator="path",
                            filename="scene.exr")
        return renderer.pbrt() + scene_desc


class SamplesRenderingParser(BaseRenderingParser):
    """CLI for per-sample .bin dumping via the instrumented renderer."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument("--gt_spp", type=int, default=512,
                          help="samples for the ground-truth target.")

    def _add_scene_header(self, scene_desc, args):
        if os.path.splitext(args.output)[-1] != "":
            raise RuntimeError("Output should be the path to a folder.")
        renderer = Renderer(path_depth=args.path_depth, spp=args.spp,
                            gt_spp=args.gt_spp,
                            pixel_filter=args.pixel_filter, width=args.width,
                            height=args.height, integrator="pathrendernet",
                            filename=args.scene_name + ".exr")
        return renderer.pbrt() + scene_desc


class PBRTRenderer:
    """Runs pbrt on a prepared scene and collects the .exr output."""

    def __init__(self, args):
        self.args = args
        self._setup()

    def _setup(self):
        args = self.args
        set_logger(args.verbose)
        os.makedirs(args.tmp_dir, exist_ok=True)
        with open(args.scene_path, "w") as fid:
            fid.write(args.scene_desc)
        # Make the scene's assets visible from the temp dir.
        for path in os.listdir(args.scene_root):
            if path == "scene.pbrt":
                continue
            dst = os.path.join(args.tmp_dir, path)
            if not os.path.exists(dst):
                os.symlink(os.path.join(args.scene_root, path), dst)

    def __del__(self):
        if os.path.exists(self.args.tmp_dir):
            shutil.rmtree(self.args.tmp_dir, ignore_errors=True)

    def _run_pbrt(self, cwd):
        stderr = None if self.args.verbose else subprocess.DEVNULL
        subprocess.check_output(
            [self.args.pbrt_exe, self.args.scene_path], stderr=stderr,
            cwd=cwd)

    def render(self):
        args = self.args
        LOG.info("Rendering %s", args.scene_name)
        self._run_pbrt(args.tmp_dir)
        src = os.path.join(args.tmp_dir, "scene.exr")
        os.makedirs(os.path.dirname(args.output), exist_ok=True)
        shutil.move(src, args.output)


class PBRTSamplesRenderer(PBRTRenderer):
    """Runs the instrumented pbrt and collects the per-sample .bin tiles."""

    def _setup(self):
        super()._setup()
        os.makedirs(self.args.output, exist_ok=True)

    def render(self):
        args = self.args
        LOG.info("Rendering %s", args.scene_name)
        # The sample-dumping renderer writes .bin tiles to its cwd.
        bindir = os.path.join(args.tmp_dir, "bin")
        os.makedirs(bindir, exist_ok=True)
        self._run_pbrt(bindir)
        for f in os.listdir(bindir):
            if os.path.splitext(f)[-1] == ".bin":
                shutil.move(os.path.join(bindir, f),
                            os.path.join(args.output, f))
