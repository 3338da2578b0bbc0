"""Material classes (reference: sbmc/scene_generator/materials.py:31-414).

Implemented as a single parameter-table-driven encoder: each material type
declares its PBRT parameters as ``(name, kind, default)`` rows; any ``rgb``
parameter may be overridden by a spectrum texture. This replaces the
reference's per-class string concatenation with one serializer.

A copy of ``sbmc_tpu/scene_generator/materials.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

__all__ = ["Material", "MatteMaterial", "UberMaterial", "MirrorMaterial",
           "GlassMaterial", "MetalMaterial", "PlasticMaterial",
           "SubstrateMaterial"]


class Material:
    """Base material: a PBRT material type plus a parameter table.

    Args:
      id: unique name for ``MakeNamedMaterial`` (anonymous ``Material``
        statement if None).
      bump_texture: optional float-texture bump map.
    """

    MTYPE = None
    #: (pbrt_name, kind, default); kind is "rgb" or "float". ``rgb``
    #: entries accept a Texture (referenced as ``"texture <name>"``).
    PARAMS = ()

    def __init__(self, id=None, bump_texture=None, **values):
        self.id = id
        self.values = {}
        self.textures = []
        self.bump_texture = bump_texture
        if bump_texture is not None:
            if bump_texture.type != "float":
                raise RuntimeError("Incorrect bump type error")
            self.textures.append(bump_texture)
        for name, kind, default in self.PARAMS:
            tex = values.pop(name + "_texture", None)
            val = values.pop(name, None)
            if tex is not None:
                self.values[name] = tex
                self.textures.append(tex)
            elif val is not None:
                self.values[name] = val
            else:
                self.values[name] = default
        if values:
            raise TypeError("unexpected material params %s" % list(values))

    def pbrt(self):
        from sbmc_tpu_torch.scene_generator.textures import Texture
        out = "".join(t.pbrt() for t in self.textures)
        if self.id:
            out += ('MakeNamedMaterial "{}" "string type" "{}"'
                    .format(self.id, self.MTYPE))
        else:
            out += 'Material "{}"'.format(self.MTYPE)
        for name, kind, _default in self.PARAMS:
            v = self.values[name]
            if isinstance(v, Texture):
                out += ' "texture {}" "{}"'.format(name, v.id)
            elif kind == "rgb":
                if not hasattr(v, "__len__"):
                    v = [v] * 3
                out += ' "rgb {}" [{} {} {}]'.format(name, *v)
            else:
                out += ' "float {}" [{}]'.format(name, v)
        if self.bump_texture is not None:
            out += ' "texture bumpmap" "{}"'.format(self.bump_texture.id)
        return out + "\n"


class MatteMaterial(Material):
    MTYPE = "matte"
    PARAMS = (("Kd", "rgb", [1, 1, 1]),)

    def __init__(self, id=None, diffuse=None, diffuse_texture=None,
                 bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture, Kd=diffuse,
                         Kd_texture=diffuse_texture)


class UberMaterial(Material):
    MTYPE = "uber"
    PARAMS = (("Kd", "rgb", [1, 1, 1]),
              ("Ks", "rgb", [0.25] * 3),
              ("Kr", "rgb", [0.0] * 3),
              ("roughness", "float", 0.1),
              ("index", "float", 1.5),
              ("opacity", "rgb", [1.0] * 3))

    def __init__(self, id=None, diffuse=None, diffuse_texture=None,
                 glossy_reflection=0.25, specular_reflection=0,
                 roughness=0.1, index=1.5, opacity=1.0, bump_texture=None):
        super().__init__(
            id=id, bump_texture=bump_texture, Kd=diffuse,
            Kd_texture=diffuse_texture, Ks=[glossy_reflection] * 3,
            Kr=[specular_reflection] * 3, roughness=roughness, index=index,
            opacity=[opacity] * 3)


class MirrorMaterial(Material):
    MTYPE = "mirror"
    PARAMS = (("Kr", "rgb", [1, 1, 1]),)

    def __init__(self, id=None, specular=None, specular_texture=None,
                 bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture, Kr=specular,
                         Kr_texture=specular_texture)


class GlassMaterial(Material):
    MTYPE = "glass"
    PARAMS = (("index", "float", 1.5),
              ("Kr", "rgb", [1, 1, 1]),
              ("Kt", "rgb", [1, 1, 1]))

    def __init__(self, id=None, reflection=None, reflection_texture=None,
                 transmission=None, transmission_texture=None, index=1.5,
                 bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture, index=index,
                         Kr=reflection, Kr_texture=reflection_texture,
                         Kt=transmission, Kt_texture=transmission_texture)


class MetalMaterial(Material):
    MTYPE = "metal"
    PARAMS = (("roughness", "float", 0.01),
              ("eta", "rgb", [0.6, 0.5, 0.4]),
              ("k", "rgb", [2, 2, 3]))

    def __init__(self, id=None, eta=None, eta_texture=None, k=None,
                 k_texture=None, roughness=0.01, bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture,
                         roughness=roughness, eta=eta,
                         eta_texture=eta_texture, k=k, k_texture=k_texture)


class PlasticMaterial(Material):
    MTYPE = "plastic"
    PARAMS = (("roughness", "float", 0.01),
              ("Kd", "rgb", [1, 1, 1]),
              ("Ks", "rgb", [1, 1, 1]))

    def __init__(self, id=None, diffuse=None, diffuse_texture=None,
                 specular=None, specular_texture=None, roughness=0.01,
                 bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture,
                         roughness=roughness, Kd=diffuse,
                         Kd_texture=diffuse_texture, Ks=specular,
                         Ks_texture=specular_texture)


class SubstrateMaterial(Material):
    MTYPE = "substrate"
    PARAMS = (("uroughness", "float", 0.1),
              ("vroughness", "float", 0.1),
              ("Kd", "rgb", [0.5] * 3),
              ("Ks", "rgb", [0.5] * 3))

    def __init__(self, id=None, diffuse=None, diffuse_texture=None,
                 specular=None, specular_texture=None, uroughness=0.1,
                 vroughness=0.1, bump_texture=None):
        super().__init__(id=id, bump_texture=bump_texture,
                         uroughness=uroughness, vroughness=vroughness,
                         Kd=diffuse, Kd_texture=diffuse_texture, Ks=specular,
                         Ks_texture=specular_texture)
