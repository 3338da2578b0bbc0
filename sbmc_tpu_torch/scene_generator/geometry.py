"""Geometric primitives (reference: sbmc/scene_generator/geometry.py:26-188).

A copy of ``sbmc_tpu/scene_generator/geometry.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

import numpy as np

__all__ = ["Shape", "Sphere", "Cylinder", "Plane", "TriangleMesh",
           "ExternalGeometry"]


class Shape:
    """Base shape: carries transform chains (incl. motion-blur start/end
    channels) and an optional named material."""

    def __init__(self):
        self.xform = None
        self.start_xform = None
        self.end_xform = None
        self.material = None

    def assign_material(self, mat):
        self.material = mat

    def _body(self):
        raise NotImplementedError

    def pbrt(self):
        s = "AttributeBegin\n"
        if self.material is not None:
            s += 'NamedMaterial "{}"\n'.format(self.material.id)
        if self.xform is not None:
            s += self.xform.pbrt()
        if self.start_xform is not None:
            s += ("ActiveTransform StartTime\n" + self.start_xform.pbrt()
                  + "ActiveTransform All\n")
        if self.end_xform is not None:
            s += ("ActiveTransform EndTime\n" + self.end_xform.pbrt()
                  + "ActiveTransform All\n")
        return s + self._body() + "AttributeEnd\n"


class Sphere(Shape):
    def __init__(self, radius=1):
        super().__init__()
        self.radius = radius

    def _body(self):
        return 'Shape "sphere" "float radius" [{}]\n'.format(self.radius)


class Cylinder(Shape):
    """Cylinder of given radius, centered on z in [-h/2, h/2]."""

    def __init__(self, radius=1, height=1):
        super().__init__()
        self.radius = radius
        self.height = height

    def _body(self):
        return ('Shape "cylinder" "float radius" [{}]\n'
                '"float zmin" [{}] "float zmax" [{}]\n'.format(
                    self.radius, -0.5 * self.height, 0.5 * self.height))


class TriangleMesh(Shape):
    def __init__(self, indices, points):
        super().__init__()
        self.indices = np.asarray(indices)
        self.points = np.asarray(points)

    def _body(self):
        idx = " ".join(str(i) for i in self.indices.ravel())
        pts = " ".join(str(p) for p in self.points.ravel())
        return ('Shape "trianglemesh" "integer indices" [{}]\n'
                '"point P" [{}]\n'.format(idx, pts))


class Plane(TriangleMesh):
    """A unit YZ-plane (two triangles) centered at the origin, scaled."""

    def __init__(self, scale=1):
        pts = scale * np.array([
            [0, -0.5, -0.5], [0, -0.5, 0.5], [0, 0.5, 0.5], [0, 0.5, -0.5]],
            dtype=np.float64)
        idx = np.array([[0, 1, 2], [2, 3, 0]])
        super().__init__(idx, pts)


class ExternalGeometry(Shape):
    """Include an external .pbrt geometry file."""

    def __init__(self, path):
        super().__init__()
        self.path = path

    def _body(self):
        return 'Include "{}"\n'.format(self.path)
