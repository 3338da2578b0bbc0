""".obj -> per-material .pbrt geometry conversion (reference:
sbmc/scene_generator/converters.py:44-224).

``ObjConverter`` tags the .obj's material groups so ``obj2pbrt`` preserves
them, runs the external converter, then splits the resulting .pbrt into one
geometry file per material group with a fresh unique material id each.

A copy of ``sbmc_tpu/scene_generator/converters.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

import os
import re
import subprocess
import uuid

from sbmc_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

__all__ = ["ObjConverter", "OBJMaterial", "PBRTObject"]

_NAME_RE = re.compile(r'^# Name\s*"(?P<obj_name>.*)".*$')
_MAT_RE = re.compile(
    r'.*"float roughness"\s\[(?P<roughness>[^\]]*)\]\s.*"float index"'
    r'\s*\[(?P<index>[^\]]*)\]\s.*"rgb opacity"\s*\[(?P<opacity>[^\]]*)\].*')
_USEMTL_RE = re.compile(r'^usemtl\s*(?P<mat>.*)\s*$')
_GROUP_RE = re.compile(r'^g\s*(?P<geo>.*)\s*$')


class OBJMaterial:
    """Material parsed from an ``obj2pbrt`` Material line (roughness /
    index / opacity), with a fresh unique id."""

    def __init__(self, line=""):
        if line == "":
            self.roughness = 0.5
            self.index = 1.0
            self.opacity = 1.0
        else:
            m = _MAT_RE.match(line)
            if m is None:
                raise RuntimeError(
                    "Parser could not understand OBJ material '%s'" % line)
            self.roughness = float(m.group("roughness"))
            self.index = float(m.group("index"))
            self.opacity = min(float(c) for c in m.group("opacity").split())
        self.id = str(uuid.uuid4()).replace("-", "_")


class PBRTObject:
    """A per-material-group geometry file plus its parsed material.

    ``name`` is the ``# Name "<geom>@<mat>"`` comment ``obj2pbrt`` carries
    through from the tagged .obj groups; :attr:`geom_name` /
    :attr:`material_group` are its two halves (the SunCG converter
    categorizes objects by them, reference suncg.py:124-186)."""

    def __init__(self, path, material, name=None):
        self.path = path
        self.material = material
        self.name = name

    def _name_parts(self):
        if self.name and "@" in self.name:
            return self.name.split("@", 1)
        return (self.name, None)

    @property
    def geom_name(self):
        return self._name_parts()[0]

    @property
    def material_group(self):
        return self._name_parts()[1]


def _tag_material_groups(src, dst):
    """Rewrite the .obj adding a ``g <geom>@<mat>`` group line before each
    ``usemtl`` so the converter keeps material groups distinct."""
    base = os.path.splitext(os.path.basename(src))[0]
    with open(src) as src_fid, open(dst, "w") as dst_fid:
        last_geom = None
        for line in src_fid:
            gm = _GROUP_RE.match(line)
            if gm:
                last_geom = gm.group("geo")
            else:
                mm = _USEMTL_RE.match(line)
                if mm:
                    owner = last_geom if last_geom is not None else base
                    dst_fid.write("g %s@%s\n" % (owner, mm.group("mat")))
            dst_fid.write(line)


def _split_pbrt_objects(in_f):
    """Split an ``obj2pbrt`` output into one .pbrt file per object,
    returning the generated :class:`PBRTObject` descriptors."""
    objects = []
    stem = os.path.splitext(in_f)[0]
    with open(in_f) as fid:
        line = fid.readline()
        while line:
            name_match = _NAME_RE.match(line)
            if name_match:
                name = name_match.group("obj_name")
                while not (line.startswith("Material")
                           or line.startswith("Shape")):
                    line = fid.readline()
                if line.startswith("Material"):
                    mat = OBJMaterial(line)
                else:
                    LOG.error("Found no material.")
                    mat = OBJMaterial("")
                while not line.startswith("Shape"):
                    line = fid.readline()
                new_f = "%s%s_object%04d.pbrt" % (stem, mat.id, len(objects))
                with open(new_f, "w") as out:
                    out.write("AttributeBegin\n")
                    out.write('NamedMaterial "%s"\n' % mat.id)
                    while line.strip() != "AttributeEnd":
                        out.write(line)
                        line = fid.readline()
                    out.write(line)
                objects.append(PBRTObject(new_f, mat, name=name))
            line = fid.readline()
    return objects


class ObjConverter:
    """Converts a .obj file into per-material .pbrt geometry files.

    Args:
      pbrt_converter: path to the ``obj2pbrt`` executable.
    """

    def __init__(self, pbrt_converter):
        self.pbrt_converter = pbrt_converter

    def __call__(self, fname, dst):
        dirname = os.path.dirname(fname)
        basename = os.path.basename(fname)
        mtl_file = os.path.splitext(basename)[0] + ".mtl"
        os.makedirs(dst, exist_ok=True)
        _tag_material_groups(fname, os.path.join(dst, basename))
        pbrt_file = basename.replace(".obj", ".pbrt")

        cwd = os.getcwd()
        os.chdir(dst)
        try:
            if not os.path.exists(mtl_file):
                os.symlink(os.path.join(dirname, mtl_file), mtl_file)
            subprocess.check_output(
                [self.pbrt_converter, basename, pbrt_file])
            objects = _split_pbrt_objects(pbrt_file)
            os.remove(basename)
            os.remove(mtl_file)
        finally:
            os.chdir(cwd)
        return objects
