"""Core PBRT scene-description classes (reference:
sbmc/scene_generator/scene.py:35-232).

These emit PBRTv2 scene strings, including the custom
``Renderer "rendernet"`` / ``SurfaceIntegrator "pathrendernet"`` directives
that the instrumented sample-recording renderer understands.

A copy of ``sbmc_tpu/scene_generator/scene.py`` (the port imports nothing
of the JAX package); scene files come out byte for byte the same.
"""

import numpy as np

__all__ = ["Scene", "Renderer", "Camera"]


class Scene:
    """A PBRT scene: renderer config, camera, lights, textures, materials
    and shapes, serialized in that order. The y axis is up."""

    def __init__(self, renderer=None, camera=None):
        self.renderer = renderer
        self.camera = camera
        self.lights = []
        self.textures = []
        self.materials = []
        self.shapes = []

    def __repr__(self):
        return (f"Scene({len(self.shapes)} shapes, "
                f"{len(self.materials)} materials, "
                f"{len(self.textures)} textures, {len(self.lights)} lights)")

    def pbrt(self):
        parts = []
        if self.renderer is not None:
            parts.append(self.renderer.pbrt())
        if self.camera is not None:
            parts.append(self.camera.pbrt())
        parts.append("TransformTimes 0.0 1.0\n\nWorldBegin\n")
        for obj in (self.lights + self.textures + self.materials
                    + self.shapes):
            parts.append(obj.pbrt())
        parts.append("WorldEnd\n")
        return "".join(parts)


class Renderer:
    """Renderer/sampler/film configuration block.

    When ``integrator="pathrendernet"`` this emits the instrumented
    sample-dumping renderer header (``Renderer "rendernet"`` with
    ``tilesize``/``recordedsamples``) and the sampler runs at ``gt_spp``
    (the ground-truth pass); otherwise the sampler runs at ``spp``.
    """

    def __init__(self, tile_size=128, spp=16, gt_spp=None, path_depth=5,
                 pixel_filter="box", height=512, width=1024,
                 random_crop_w=None, random_crop_h=None,
                 integrator="pathrendernet", sampler="lowdiscrepancy",
                 filename=None):
        self.tile_size = tile_size
        self.spp = spp
        self.gt_spp = gt_spp
        self.path_depth = path_depth
        self.pixel_filter = pixel_filter
        self.height = height
        self.width = width
        self.random_crop_w = random_crop_w
        self.random_crop_h = random_crop_h
        self.integrator = integrator
        self.sampler = sampler
        self.filename = filename

        if self.integrator == "pathrendernet":
            if self.path_depth != 5:
                raise RuntimeError(
                    "Sample-based rendering only supports path_depth=5, "
                    "got %d" % self.path_depth)
            if self.gt_spp is None:
                raise RuntimeError(
                    "Sample-based rendering requires `gt_spp` to be set")

    def pbrt(self):
        out = ('SurfaceIntegrator "%s" "integer maxdepth" [%d]\n'
               % (self.integrator, self.path_depth))
        if self.integrator == "pathrendernet":
            out += ('Renderer "rendernet" "integer tilesize" [%d] '
                    '"integer recordedsamples" [%d]\n'
                    % (self.tile_size, self.spp))
            sampler_spp = self.gt_spp  # the reference pass drives sampling
        else:
            sampler_spp = self.spp
        out += ('Sampler "%s" "integer pixelsamples" [%d]\n'
                % (self.sampler, sampler_spp))
        out += 'PixelFilter "%s"\n' % self.pixel_filter
        out += self._film()
        return out

    def _film(self):
        film = ('Film "image" "integer xresolution" [%d]'
                ' "integer yresolution" [%d]' % (self.width, self.height))
        if self.filename is not None:
            film += ' "string filename" "%s"\n\n' % self.filename
        if self.random_crop_w is not None:
            if self.random_crop_h is None:
                raise RuntimeError("Please provide both x/y crop.")
            start_x = start_y = 0.0
            if self.random_crop_w < self.width:
                start_x = np.random.randint(
                    0, self.width - self.random_crop_w) / self.width
            if self.random_crop_h < self.height:
                start_y = np.random.randint(
                    0, self.height - self.random_crop_h) / self.height
            fw = self.random_crop_w / self.width
            fh = self.random_crop_h / self.height
            film += (' "float cropwindow" [%s %s %s %s]'
                     % (start_x, start_x + fw, start_y, start_y + fh))
        return film + "\n"


class Camera:
    """Perspective (or other) camera with optional DoF and shutter span."""

    def __init__(self, xform=None, position=None, target=None, up=None,
                 type="perspective", fov=35, shutteropen=0.0,
                 shutterclose=0.0, lensradius=0.0, focaldistance=0.0):
        self.xform = xform
        self.position = position if position is not None else [0, 0, 1]
        self.target = target if target is not None else [0, 0, 0]
        self.up = up if up is not None else [0, 1, 0]
        self.type = type
        self.fov = fov
        self.shutteropen = shutteropen
        self.shutterclose = shutterclose
        self.lensradius = lensradius
        self.focaldistance = focaldistance

    def __repr__(self):
        return ("Camera(fov=%s, at=%s, target=%s, shutter=(%s, %s), "
                "focus=%s, lens=%s)" % (self.fov, self.position, self.target,
                                        self.shutteropen, self.shutterclose,
                                        self.focaldistance, self.lensradius))

    def pbrt(self):
        if self.xform is None:
            vals = list(self.position) + list(self.target) + list(self.up)
            s = "LookAt " + " ".join(
                "{} {} {}".format(*vals[i:i + 3]) for i in (0, 3, 6)) + "\n"
        else:
            s = self.xform.pbrt()
        s += ('Camera "%s" "float fov" [%s] "float shutteropen" [%s] '
              '"float shutterclose" [%s] "float lensradius" [%s]'
              ' "float focaldistance" [%s]\n'
              % (self.type, self.fov, self.shutteropen, self.shutterclose,
                 self.lensradius, self.focaldistance))
        return s
