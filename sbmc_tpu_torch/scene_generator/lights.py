"""Light sources (reference: sbmc/scene_generator/lights.py:24-131).

A copy of ``sbmc_tpu/scene_generator/lights.py`` (the port imports nothing
of the JAX package); scene files come out byte for byte the same.
"""

__all__ = ["PointLight", "InfiniteLight", "InifiniteLight", "AreaLight"]


class _Light:
    def __init__(self):
        self.xform = None

    def _body(self):
        raise NotImplementedError

    def pbrt(self):
        s = "AttributeBegin\n"
        if self.xform is not None:
            s += self.xform.pbrt()
        return s + self._body() + "AttributeEnd\n"


class PointLight(_Light):
    def __init__(self, spectrum=None):
        super().__init__()
        self.spectrum = spectrum if spectrum is not None else [1, 1, 1]

    def _body(self):
        return ('LightSource "point" "rgb I" [{} {} {}]\n'
                .format(*self.spectrum))


class InfiniteLight(_Light):
    """Infinitely distant light; with ``mapname`` set acts as an envmap
    (the map's color overrides ``spectrum``)."""

    def __init__(self, spectrum=None, mapname=None, nsamples=8):
        super().__init__()
        self.nsamples = nsamples
        self.mapname = mapname
        self.spectrum = None
        if mapname is None:
            self.spectrum = spectrum if spectrum is not None else [1, 1, 1]

    def _body(self):
        s = 'LightSource "infinite" '
        if self.mapname is None:
            s += '"rgb L" [{} {} {}]'.format(*self.spectrum)
        else:
            s += '"string mapname" ["{}"]'.format(self.mapname)
        s += ' "integer nsamples" [{}]\n'.format(self.nsamples)
        return s


#: Alias kept for API parity with the reference (which (mis)spells it this
#: way, sbmc/scene_generator/lights.py:61).
InifiniteLight = InfiniteLight


class AreaLight(_Light):
    """Geometric area light wrapping a Shape."""

    def __init__(self, geom, spectrum=None, nsamples=8):
        super().__init__()
        self.geom = geom
        self.nsamples = nsamples
        self.spectrum = spectrum if spectrum is not None else [1, 1, 1]

    def _body(self):
        s = 'AreaLightSource "diffuse" "rgb L" [{} {} {}]'.format(
            *self.spectrum)
        s += ' "integer nsamples" [{}]\n'.format(self.nsamples)
        s += self.geom.pbrt()
        return s
