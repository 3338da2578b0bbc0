"""Transform stacks with motion-blur channels (reference:
sbmc/scene_generator/xforms.py:24-278).

Objects carry up to three transform chains: ``default``, and ``start``/
``end`` channels evaluated at shutter open/close for motion blur
(``ActiveTransform StartTime/EndTime`` in the PBRT output).

A copy of ``sbmc_tpu/scene_generator/xforms.py`` (the port imports nothing
of the JAX package); scene files come out byte for byte the same.
"""

__all__ = ["translate", "rotate", "scale", "transform", "look_at",
           "Transform"]


class Transform:
    """Composition of elementary transforms, emitted back-to-front."""

    def __init__(self):
        self.xforms = []

    def push(self, xf):
        self.xforms.append(xf)

    def pbrt(self):
        return "".join(xf.pbrt() for xf in reversed(self.xforms))


class _Elementary:
    _TEMPLATE = ""

    def __init__(self, *vals):
        self.vals = list(vals)

    def pbrt(self):
        return self._TEMPLATE.format(*self.vals)


class Translation(_Elementary):
    _TEMPLATE = "Translate {} {} {}\n"

    def __init__(self, t):
        super().__init__(*t)


class Scale(_Elementary):
    _TEMPLATE = "Scale {} {} {}\n"

    def __init__(self, s):
        super().__init__(*s)


class Rotation(_Elementary):
    _TEMPLATE = "Rotate {} {} {} {}\n"

    def __init__(self, axis, angle):
        super().__init__(angle, *axis)


class LookAt(_Elementary):
    _TEMPLATE = "LookAt {} {} {}  {} {} {}  {} {} {}\n"

    def __init__(self, src, dst, up):
        super().__init__(*src, *dst, *up)


class Mat44(_Elementary):
    _TEMPLATE = "Transform [" + " {}" * 16 + "]\n"

    def __init__(self, coeffs):
        if len(coeffs) != 16:
            raise ValueError("Mat44 needs 16 row-major coefficients")
        super().__init__(*coeffs)


def _push(obj, xf, target):
    attr = {"default": "xform", "start": "start_xform",
            "end": "end_xform"}.get(target)
    if attr is None:
        raise ValueError("unknown xform target %s, should be one of "
                         "`default`, `start`, `end`" % target)
    chain = getattr(obj, attr)
    if chain is None:
        chain = Transform()
        setattr(obj, attr, chain)
    chain.push(xf)


def translate(obj, t, target="default"):
    """Push a translation onto ``obj``'s transform chain."""
    _push(obj, Translation(t), target)


def rotate(obj, axis, angle, target="default"):
    """Push a rotation (``angle`` in degrees about ``axis``)."""
    _push(obj, Rotation(axis, angle), target)


def scale(obj, mag, target="default"):
    """Push a (3-component) scale."""
    _push(obj, Scale(mag), target)


def transform(obj, coeffs, target="default"):
    """Push a generic row-major 4x4 matrix transform."""
    _push(obj, Mat44(coeffs), target)


def look_at(obj, src, dst, up, target="default"):
    """Push a look-at transform."""
    _push(obj, LookAt(src, dst, up), target)
