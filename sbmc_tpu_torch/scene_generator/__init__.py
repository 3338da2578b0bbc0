"""Procedural PBRT scene generation for training-data synthesis
(reference: sbmc/scene_generator/).

A copy of ``sbmc_tpu/scene_generator/__init__.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

from sbmc_tpu_torch.scene_generator.scene import (  # noqa: F401
    Scene, Renderer, Camera)
from sbmc_tpu_torch.scene_generator.geometry import (  # noqa: F401
    Shape, Sphere, Cylinder, Plane, TriangleMesh, ExternalGeometry)
from sbmc_tpu_torch.scene_generator.lights import (  # noqa: F401
    PointLight, InfiniteLight, InifiniteLight, AreaLight)
from sbmc_tpu_torch.scene_generator.xforms import (  # noqa: F401
    translate, rotate, scale, transform, look_at, Transform)
from sbmc_tpu_torch.scene_generator.materials import (  # noqa: F401
    Material, MatteMaterial, UberMaterial, MirrorMaterial, GlassMaterial,
    MetalMaterial, PlasticMaterial, SubstrateMaterial)
from sbmc_tpu_torch.scene_generator.textures import (  # noqa: F401
    Texture, Imagemap, Checkerboard)
from sbmc_tpu_torch.scene_generator import randomizers  # noqa: F401
from sbmc_tpu_torch.scene_generator.randomizers import (  # noqa: F401
    random_texture, random_envmap, random_material, random_bump)
from sbmc_tpu_torch.scene_generator.converters import (  # noqa: F401
    ObjConverter, OBJMaterial, PBRTObject)
from sbmc_tpu_torch.scene_generator.generators import (  # noqa: F401
    OutdoorSceneGenerator, poisson_disc_samples)
from sbmc_tpu_torch.scene_generator.suncg import (  # noqa: F401
    SunCGConverter, SunCGSceneGenerator, InvalidSunCGSceneError)
