"""SunCG indoor-scene conversion and generation (legacy).

Functional port of the reference's unmaintained SunCG pipeline
(reference: sbmc/scene_generator/suncg.py:44-577). The SunCG dataset was
withdrawn in 2019, so — exactly like the reference, which keeps the code
but ships it disabled (reference: scripts/generate_training_data.py:99-103)
— this generator is not wired into the default data-generation path; it is
exercised in the test suite against a synthetic miniature SunCG tree
(tests/test_torch_scene_generator.py).

Expected on-disk layout (the original distribution's):

    <root>/project_ids.txt              house ids, one per line
    <root>/house/<id>/house.json        level/node graph with bboxes
    <root>/room/<id>/<modelId>{c,f,w}.obj   ceiling/floor/wall geometry
    <root>/object/<modelId>/<modelId>.obj   furniture models
    <root>/cameras/<id>/room_camera{,_good,_name}.txt  curated viewpoints
    <root>/pbrs/util_data/ModelCategoryMappingNewActive.csv
    <root>/pbrs/util_data/light_geometry_compact.txt

A scene sample picks a curated camera, converts the camera's room plus its
furniture through ``obj2pbrt``, categorizes each material group
(window/door/mirror/light-bulb/lamp-shade) from the category mapping and
light-geometry tables, then randomizes: window treatment (keep glass /
remove / turn into area lights), materials, camera up/fov/DoF, and
motion-blurred free-floating props.

A copy of ``sbmc_tpu/scene_generator/suncg.py`` (the port imports nothing
of the JAX package); scene files come out byte for byte the same.
"""

import csv
import json
import os

import numpy as np

from sbmc_tpu_torch.scene_generator import geometry, randomizers, xforms
from sbmc_tpu_torch.scene_generator.generators import (
    SceneGenerator, _random_aperture)
from sbmc_tpu_torch.scene_generator.lights import AreaLight
from sbmc_tpu_torch.scene_generator.materials import (MirrorMaterial,
                                                      UberMaterial)
from sbmc_tpu_torch.scene_generator.scene import Camera

__all__ = ["SunCGConverter", "SunCGSceneGenerator",
           "InvalidSunCGSceneError"]


class InvalidSunCGSceneError(RuntimeError):
    """Raised when a sampled SunCG configuration cannot make a scene
    (no curated camera, no light source, ...); the caller retries."""


class SunCGConverter:
    """Resolves SunCG asset paths and converts rooms/objects to per-material
    .pbrt geometry (reference suncg.py:44-312).

    Args:
      suncg_root: root of the SunCG distribution (layout in module doc).
      obj_converter: an :class:`~sbmc_tpu_torch.scene_generator.ObjConverter`
        (or compatible callable ``(obj_path, dst_dir) -> [PBRTObject]``).
    """

    def __init__(self, suncg_root, obj_converter):
        self.root = suncg_root
        self.houses = os.path.join(suncg_root, "house")
        self.cameras = os.path.join(suncg_root, "cameras")
        self.objects = os.path.join(suncg_root, "object")
        self.rooms = os.path.join(suncg_root, "room")
        self._convert = obj_converter

        util = os.path.join(suncg_root, "pbrs", "util_data")
        self.classes = self._load_classes(
            os.path.join(util, "ModelCategoryMappingNewActive.csv"))
        self.light_materials = self._load_light_materials(
            os.path.join(util, "light_geometry_compact.txt"))

        with open(os.path.join(suncg_root, "project_ids.txt")) as fid:
            self.plist = [ln.strip() for ln in fid if ln.strip()]

    # -- asset tables -------------------------------------------------------

    @staticmethod
    def _load_classes(mapping_file):
        """Model ids to remove (people/plants), treat as transparent
        (windows/doors) or as mirrors, from the category-mapping CSV
        (reference suncg.py:196-229)."""
        groups = {"window": [], "door": [], "plant": [], "person": [],
                  "mirror": []}
        aliases = {"windows": "window", "people": "person"}
        with open(mapping_file) as fid:
            for row in csv.DictReader(fid):
                for col in ("fine_grained_class", "coarse_grained_class",
                            "nyuv2_40class"):
                    cls = aliases.get(row.get(col, ""), row.get(col, ""))
                    if cls in groups:
                        groups[cls].append(row["model_id"])
                        break
        return {
            "remove": groups["person"] + groups["plant"],
            "transparent": groups["window"] + groups["door"],
            "mirror": groups["mirror"],
        }

    @staticmethod
    def _load_light_materials(lighting_file):
        """Per-light-model bulb/shade material-group ids, from the compact
        light-geometry table: ``<model> <nbulbs> <ids...> <nshades>
        <ids...>`` per line (reference suncg.py:231-260)."""
        models, bulbs, shades = [], [], []
        with open(lighting_file) as fid:
            for line in fid:
                data = line.split()
                if not data:
                    continue
                models.append(data[0])
                i = 1
                n = int(data[i])
                bulbs.append(data[i + 1:i + 1 + n])
                i += 1 + n
                n = int(data[i])
                shades.append(data[i + 1:i + 1 + n])
        return {"models": models, "bulbs": bulbs, "shades": shades}

    # -- house metadata -----------------------------------------------------

    def load_housedata(self, scene):
        with open(os.path.join(self.houses, scene, "house.json")) as fid:
            return json.load(fid)

    def cameras_for_scene(self, scene, shuffle=False):
        """Curated viewpoints: position+direction+up from room_camera.txt,
        filtered by the room_camera_good.txt flags, tagged with their room
        id from room_camera_name.txt (reference suncg.py:268-293).
        Returns None when the scene has no curated cameras."""
        good_f = os.path.join(self.cameras, scene, "room_camera_good.txt")
        if not os.path.exists(good_f):
            return None
        with open(good_f) as fid:
            good = [bool(ln.strip()) for ln in fid]
        with open(os.path.join(self.cameras, scene,
                               "room_camera.txt")) as fid:
            cams = [[float(c) for c in ln.split()] for ln in fid]
        with open(os.path.join(self.cameras, scene,
                               "room_camera_name.txt")) as fid:
            for i, ln in enumerate(fid):
                # "<project>#<level>_<room>_<cam>" -> room id "<level>_<room>"
                room = "_".join(ln.strip().split("#")[-1].split("_")[:-1])
                cams[i] = {"camera": cams[i], "room": room}
        cams = [c for c, g in zip(cams, good) if g]
        if shuffle:
            np.random.shuffle(cams)
        return cams

    # -- geometry conversion ------------------------------------------------

    def convert_room(self, scene, room_node, dst_dir):
        """Convert a room's ceiling/floor/wall .objs (``<modelId>{c,f,w}``)
        (reference suncg.py:67-83)."""
        objects = []
        for ext in ("c", "f", "w"):
            obj_file = os.path.join(
                self.rooms, scene, room_node["modelId"] + ext + ".obj")
            if not os.path.exists(obj_file):
                raise InvalidSunCGSceneError(
                    "room file does not exist: %s" % obj_file)
            objects += self._convert(obj_file, dst_dir)
        return [(o, None) for o in objects]

    def convert_object(self, node, dst_dir):
        """Convert a furniture node's model; articulated objects encode
        their state as a ``_<state-1>`` model suffix (reference
        suncg.py:85-101). Returns ``(PBRTObject, world transform)`` pairs."""
        mdl_id = node["modelId"]
        obj_dir = os.path.join(self.objects, mdl_id)
        if node.get("state", 0) != 0:
            mdl_id += "_%d" % (node["state"] - 1)
        obj_file = os.path.join(obj_dir, mdl_id + ".obj")
        xform = node.get("transform")
        return [(o, xform) for o in self._convert(obj_file, dst_dir)]

    # -- categorization -----------------------------------------------------

    def get_obj_category(self, name, mat_group):
        """window/door -> "transparent", mirror -> "mirror", known light
        models -> "light_bulb"/"light_shade" by material group, else
        "shape" (reference suncg.py:295-312)."""
        if name in self.classes["transparent"]:
            return "transparent"
        if name in self.classes["mirror"]:
            return "mirror"
        if name in self.light_materials["models"]:
            idx = self.light_materials["models"].index(name)
            if mat_group in self.light_materials["shades"][idx]:
                return "light_shade"
            if mat_group in self.light_materials["bulbs"][idx]:
                return "light_bulb"
        return "shape"


class SunCGSceneGenerator(SceneGenerator):
    """Random indoor scene from a SunCG house (reference suncg.py:314-577).

    Args:
      envmaps/textures/models/pbrt_converter: as
        :class:`~sbmc_tpu_torch.scene_generator.generators.SceneGenerator`
        (``models`` provides the motion-blurred prop library).
      suncg_root: root of the SunCG distribution.
    """

    def __init__(self, envmaps, textures, models, pbrt_converter,
                 suncg_root):
        super().__init__(envmaps, textures, models, pbrt_converter)
        self._suncg = SunCGConverter(suncg_root, self._converter)

    def sample(self, scn, dst_dir, params=None):
        """Populate ``scn`` from a random house/room; returns False when
        the draw is invalid and the caller should retry."""
        self._randomize_textures()
        do_dof = bool(np.random.choice([True, False]))
        do_mblur = bool(np.random.choice([True, False]))
        geom_dir = os.path.join(dst_dir, "geometry")

        try:
            scene = str(np.random.choice(self._suncg.plist))
            cam = self._random_viewpoint(scene)
            nodes = self._house_nodes(scene, cam["room"])
            objects, room_bbox = self._parse_scene(scene, cam["room"],
                                                   nodes, geom_dir)
            self._populate(scn, objects)
            cam_params, p0, cam_vec = self._randomize_camera(
                cam, do_dof, room_bbox)
            if do_mblur:
                self._add_motion_blur_props(
                    scn, room_bbox, geom_dir, p0, cam_vec)
                cam_params["shutterclose"] = 1.0
            scn.camera = Camera(**cam_params)
        except InvalidSunCGSceneError as e:
            self._log.debug("invalid SunCG scene: %s", e)
            return False

        if do_mblur and (scn.camera.shutteropen != 0.0
                         or scn.camera.shutterclose != 1.0):
            return False
        if do_dof and not (scn.camera.lensradius > 0.0
                           and scn.camera.focaldistance > 0.0):
            return False
        return True

    # -- house parsing ------------------------------------------------------

    def _random_viewpoint(self, scene):
        cams = self._suncg.cameras_for_scene(scene, shuffle=True)
        if not cams:
            raise InvalidSunCGSceneError("no curated camera for %s" % scene)
        return cams[np.random.randint(len(cams))]

    def _house_nodes(self, scene, room_id):
        """The node list of the level containing ``room_id`` (room ids are
        ``<level>_<index>``, reference suncg.py:368-374)."""
        house = self._suncg.load_housedata(scene)
        lvl = int(room_id.split("_")[0])
        return house["levels"][lvl]["nodes"]

    def _parse_scene(self, scene, room_id, nodes, geom_dir):
        """Convert the selected room's architecture + furniture into
        categorized objects (reference suncg.py:376-404). Returns
        ``([{path, category, material, transform}], room bbox)``."""
        out = []
        room_bbox = None
        for node in nodes:
            if node.get("type") != "Room" or node.get("id") != room_id:
                continue
            room_bbox = node["bbox"]
            converted = self._suncg.convert_room(scene, node, geom_dir)
            prefix = "room_"
            for idx in node.get("nodeIndices", []):
                obj = nodes[idx]
                if "modelId" not in obj or obj.get("valid") != 1:
                    continue
                converted += self._suncg.convert_object(obj, geom_dir)
            for pbrt_obj, xform in converted:
                cat = self._suncg.get_obj_category(
                    pbrt_obj.geom_name, pbrt_obj.material_group)
                out.append({
                    "path": pbrt_obj.path,
                    "category": (prefix + cat) if xform is None else cat,
                    "material": pbrt_obj.material,
                    "transform": xform,
                })
        if room_bbox is None:
            raise InvalidSunCGSceneError("room %s not found" % room_id)
        return out, room_bbox

    # -- scene population ---------------------------------------------------

    def _populate(self, scn, objects):
        """Window treatment + lights + materials (reference
        suncg.py:406-463). Requires at least one light source."""
        window_mode = str(np.random.choice(["keep", "remove", "area_light"]))

        if window_mode != "area_light" and self._envmaps:
            env = randomizers.random_envmap(self._envmaps, nsamples=8)
            # SunCG is y-up; rotate the envmap into this generator's z-up
            # frame before the random azimuth spin.
            xforms.rotate(env, [1, 0, 0], -90)
            xforms.rotate(env, [0, 0, 1], np.random.uniform(0, 360))
            scn.lights.append(env)

        nlights = 0
        for o in objects:
            cat = o["category"]
            mat = o["material"]
            if self._is_light(o, window_mode):
                light = AreaLight(
                    geom=geometry.ExternalGeometry(o["path"]),
                    spectrum=[float(np.random.uniform(10, 30))] * 3)
                if o["transform"] is not None:
                    xforms.transform(light, np.array(o["transform"]))
                scn.lights.append(light)
                nlights += 1
            elif cat == "transparent" and window_mode == "remove":
                # Removed windows let the envmap in: counts as a light.
                nlights += 1
            elif cat.endswith("light_shade"):
                continue
            else:
                geom = geometry.ExternalGeometry(o["path"])
                if o["transform"] is not None:
                    xforms.transform(geom, np.array(o["transform"]))
                scn.shapes.append(geom)
                if window_mode == "keep" and cat == "transparent" \
                        and mat.opacity < 1.0:
                    nlights += 1  # light comes through the glass
                    m = UberMaterial(id=mat.id, opacity=mat.opacity,
                                     roughness=mat.roughness,
                                     index=mat.index)
                elif cat == "mirror":
                    m = MirrorMaterial(id=mat.id)
                else:
                    m = randomizers.random_material(
                        id=mat.id, textures_list=self._current_textures)
                scn.materials.append(m)

        if nlights == 0:
            raise InvalidSunCGSceneError("no light in scene")

    def _is_light(self, o, window_mode):
        """Bulb material groups are always emitters; window glass becomes
        an emitter under the "area_light" treatment (reference
        suncg.py:563-568)."""
        if o["category"].endswith("light_bulb"):
            return True
        return (window_mode == "area_light"
                and o["category"] == "transparent"
                and o["material"].opacity < 1.0)

    # -- camera + motion blur -----------------------------------------------

    def _randomize_camera(self, cam, do_dof, room_bbox):
        """Curated position/direction, randomized up (half the time),
        fov U(35,60), optional DoF focused on a point in the room at least
        1m along the view axis (reference suncg.py:465-498)."""
        c = cam["camera"]
        p0 = np.array(c[0:3], np.float64)
        cam_vec = np.array(c[3:6], np.float64)
        up = list(c[6:9])
        if np.random.choice([True, False]):
            up = list(np.random.uniform(size=3))
        params = {
            "position": list(p0),
            "target": list(p0 + cam_vec),
            "up": up,
            "fov": float(np.random.uniform(35, 60)),
        }
        if do_dof:
            for _ in range(100):
                tgt = self._sample_point_in_room(room_bbox)
                fdist = float(np.dot(tgt - p0, cam_vec))
                if fdist >= 1.0:  # forbid focus closer than 1m
                    params["lensradius"] = _random_aperture()
                    params["focaldistance"] = fdist
                    break
            else:
                raise InvalidSunCGSceneError("no valid DoF focus point")
        return params, p0, cam_vec

    def _add_motion_blur_props(self, scn, room_bbox, geom_dir, p0, cam_vec):
        """5-25 randomly placed/scaled/rotated prop models with exponential
        motion vectors (reference suncg.py:500-542)."""
        if not self._models:
            raise InvalidSunCGSceneError("no prop models for motion blur")
        for _ in range(np.random.randint(5, 25)):
            mdl = np.random.choice(self._models)
            pbrt_objects = self._converter(mdl, geom_dir)

            src = None
            for _ in range(100):
                cand = self._sample_point_in_room(room_bbox, margin=0.01)
                if float(np.dot(cand - p0, cam_vec)) >= 1.0:
                    src = cand
                    break
            if src is None:
                raise InvalidSunCGSceneError("no valid prop position")

            rot = np.random.uniform(0, 360)
            rot_axis = np.random.uniform(size=3)
            rot_axis = list(rot_axis / np.linalg.norm(rot_axis))
            scl = list(np.random.uniform(0.5, 3.5) * np.ones(3))
            mvec = np.random.uniform(size=3)
            mvec = list(mvec / np.linalg.norm(mvec)
                        * np.random.exponential(0.3))

            for obj in pbrt_objects:
                geom = geometry.ExternalGeometry(obj.path)
                xforms.scale(geom, scl)
                xforms.rotate(geom, rot_axis, rot)
                xforms.translate(geom, list(src))
                xforms.translate(geom, mvec, target="end")
                scn.shapes.append(geom)
                scn.materials.append(randomizers.random_material(
                    id=obj.material.id,
                    textures_list=self._current_textures))

    @staticmethod
    def _sample_point_in_room(room_bbox, margin=0.0):
        """Uniform point in the room bbox, optionally inflated by
        ``margin`` (reference suncg.py:570-577)."""
        lo = np.array(room_bbox["min"], np.float64) * (1 + margin)
        hi = np.array(room_bbox["max"], np.float64) * (1 + margin)
        return np.random.uniform(lo, hi)
