"""Random scene-content samplers (reference:
sbmc/scene_generator/randomizers.py:27-258).

Material mixture: 5% mirror, 5% glass, 10% metal, 20% plastic, 10%
substrate, 30% uber, 20% diffuse; 1% of materials are untextured.

A copy of ``sbmc_tpu/scene_generator/randomizers.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

import copy
import uuid

import numpy as np

from sbmc_tpu_torch.scene_generator import lights, materials, textures

__all__ = ["random_texture", "random_envmap", "random_material",
           "random_bump", "random_diffuse_material", "random_uber_material",
           "random_mirror_material", "random_glass_material",
           "random_metal_material", "random_plastic_material",
           "random_substrate_material"]


def random_texture(textures_list, gamma=1.0):
    """Random image texture with randomized UV scale/offset."""
    texname = np.random.choice(textures_list)
    return textures.Imagemap(
        str(uuid.uuid4()), "spectrum", texname, gamma=gamma,
        udelta=np.random.uniform(0, 1), vdelta=np.random.uniform(0, 1),
        uscale=np.random.uniform(0.1, 20), vscale=np.random.uniform(0.1, 20))


def random_envmap(maps, nsamples=8):
    """Random environment-map light from a list of .pfm images."""
    return lights.InfiniteLight(mapname=np.random.choice(maps),
                                nsamples=nsamples)


def _maybe_texture(textures_list, gamma=1.0):
    if not textures_list:  # None or empty library -> untextured
        return None
    return random_texture(textures_list, gamma=gamma)


def random_diffuse_material(id=None, textures_list=None):
    tex = _maybe_texture(textures_list)
    if tex is not None:
        return materials.MatteMaterial(id=id, diffuse_texture=tex)
    return materials.MatteMaterial(
        id=id, diffuse=list(np.random.uniform(size=3)))


def random_uber_material(id=None, textures_list=None):
    tex = _maybe_texture(textures_list)
    if tex is not None:
        return materials.UberMaterial(
            id=id, diffuse_texture=tex,
            glossy_reflection=np.random.uniform(0, 1),
            specular_reflection=np.random.uniform(0, 1),
            roughness=np.random.uniform(0, 1),
            index=np.random.uniform(1, 1.5))
    return materials.UberMaterial(
        id=id, diffuse=list(np.random.uniform(size=3)))


def random_mirror_material(id=None, textures_list=None):
    return materials.MirrorMaterial(
        id=id, specular=list(np.random.uniform(size=3)))


def random_glass_material(id=None, textures_list=None):
    return materials.GlassMaterial(
        id=id, reflection=list(np.random.uniform(size=3)),
        transmission=list(np.random.uniform(size=3)))


def random_metal_material(id=None, textures_list=None):
    return materials.MetalMaterial(
        id=id, eta=list(np.random.uniform(size=3)),
        k=list(np.random.uniform(1, 3, size=3)),
        roughness=np.random.uniform(0, 1))


def random_plastic_material(id=None, textures_list=None):
    tex = _maybe_texture(textures_list)
    rough = np.random.uniform(0, 1)
    if tex is not None:
        return materials.PlasticMaterial(
            id=id, diffuse_texture=tex, roughness=rough,
            specular=list(np.random.uniform(0, 1, size=3)))
    return materials.PlasticMaterial(
        id=id, diffuse=list(np.random.uniform(size=3)), roughness=rough)


def random_substrate_material(id=None, textures_list=None):
    tex = _maybe_texture(textures_list)
    uv = (np.random.uniform(0, 1), np.random.uniform(0, 1))
    if tex is not None:
        return materials.SubstrateMaterial(
            id=id, diffuse_texture=tex,
            specular=list(np.random.uniform(0, 1, size=3)),
            uroughness=uv[0], vroughness=uv[1])
    return materials.SubstrateMaterial(
        id=id, diffuse=list(np.random.uniform(size=3)),
        uroughness=uv[0], vroughness=uv[1])


def random_material(id=None, textures_list=None):
    """Random material, biased towards simple diffuse materials."""
    p = np.random.uniform()
    if id is None:
        id = str(uuid.uuid4())
    tex = None if np.random.uniform() < 0.01 else textures_list
    if p < 0.05:
        return random_mirror_material(id, tex)
    if p < 0.1:
        return random_glass_material(id, tex)
    if p < 0.2:
        return random_metal_material(id, tex)
    if p < 0.4:
        return random_plastic_material(id, tex)
    if p < 0.5:
        return random_substrate_material(id, tex)
    if p < 0.8:
        return random_uber_material(id, tex)
    return random_diffuse_material(id, tex)


def random_bump(ref_texture, textures_list):
    """Random bump map; 50% chance of none, then 50% chance of a texture
    decorrelated from the color map."""
    if textures_list is None or np.random.uniform() <= 0.5:
        return None
    if ref_texture is None or np.random.uniform() > 0.5:
        return textures.Imagemap(
            str(uuid.uuid4()), "float", np.random.choice(textures_list),
            scale=np.random.uniform(0.01, 0.05), gamma=1.0, trilinear=True)
    bump = copy.deepcopy(ref_texture)
    bump.type = "float"
    return bump
