"""Texture classes (reference: sbmc/scene_generator/textures.py:30-139).

A copy of ``sbmc_tpu/scene_generator/textures.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

__all__ = ["Texture", "Imagemap", "Checkerboard"]


class Texture:
    """Base texture with UV scale/offset parameters.

    Args:
      id: unique identifier referenced by materials.
      type: "spectrum" or "float".
    """

    def __init__(self, id, type, uscale=1.0, vscale=1.0, udelta=0.0,
                 vdelta=0.0):
        if type not in ("spectrum", "float"):
            raise RuntimeError("Unknown texture type %s" % type)
        self.id = id
        self.type = type
        self.uscale = uscale
        self.vscale = vscale
        self.udelta = udelta
        self.vdelta = vdelta

    def _body(self):
        raise NotImplementedError

    def pbrt(self):
        s = 'Texture "{}" "{}" '.format(self.id, self.type)
        s += self._body()
        s += ('"float uscale" [{}] "float vscale" [{}] "float udelta" [{}] '
              '"float vdelta" [{}]'.format(self.uscale, self.vscale,
                                           self.udelta, self.vdelta))
        return s + "\n"


class Imagemap(Texture):
    """Bitmap-backed texture (PBRT2 supports .tga/.bmp/.pfm images)."""

    def __init__(self, id, type, filename, scale=1.0, gamma=1.0,
                 trilinear=False, uscale=1.0, vscale=1.0, udelta=1.0,
                 vdelta=1.0):
        super().__init__(id, type, uscale=uscale, vscale=vscale,
                         udelta=udelta, vdelta=vdelta)
        self.filename = filename
        self.scale = scale
        self.gamma = gamma
        self.trilinear = trilinear

    def _body(self):
        return (' "imagemap" "string filename" ["{}"] "float gamma" [{}] '
                '"float scale" [{}] "bool trilinear" ["{}"]\n'.format(
                    self.filename, self.gamma, self.scale,
                    "true" if self.trilinear else "false"))


class Checkerboard(Texture):
    """Procedural two-color checker."""

    def __init__(self, id, type, uscale=1.0, vscale=1.0, udelta=1.0,
                 vdelta=1.0, tex1=None, tex2=None):
        super().__init__(id, type, uscale=uscale, vscale=vscale,
                         udelta=udelta, vdelta=vdelta)
        self.tex1 = tex1 if tex1 is not None else [0.9, 0.9, 0.9]
        self.tex2 = tex2 if tex2 is not None else [0.2, 0.2, 0.2]

    def _body(self):
        return (' "checkerboard" "rgb tex1" [{} {} {}] "rgb tex2" '
                '[{} {} {}]\n'.format(*self.tex1, *self.tex2))
