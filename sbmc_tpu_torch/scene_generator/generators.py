"""Random scene generators (reference:
sbmc/scene_generator/generators.py:37-265).

``OutdoorSceneGenerator`` samples a camera on a ring around the origin,
places objects by Poisson-disc sampling inside the camera frustum (max 50),
randomizes materials/textures, optional per-object motion blur and
depth-of-field focused on a random object, a textured ground plane and a
random HDR environment map. Unlike the reference, the ground plane is added
once per scene rather than once per object (a reference quirk,
generators.py:193-200).

A copy of ``sbmc_tpu/scene_generator/generators.py`` (the port imports
nothing of the JAX package); scene files come out byte for byte the same.
"""

import os

import numpy as np

from sbmc_tpu_torch.scene_generator import geometry, randomizers, xforms
from sbmc_tpu_torch.scene_generator.converters import ObjConverter
from sbmc_tpu_torch.scene_generator.scene import Camera
from sbmc_tpu_torch.utils.logging import get_logger

__all__ = ["OutdoorSceneGenerator", "poisson_disc_samples"]


def poisson_disc_samples(width, height, r, k=30, rng=np.random):
    """Bridson's Poisson-disc sampling in a ``width x height`` rectangle
    with minimum distance ``r`` (stand-in for the ``bridson`` pip package
    the reference uses, generators.py:22)."""
    cell = r / np.sqrt(2)
    gw, gh = int(np.ceil(width / cell)), int(np.ceil(height / cell))
    grid = -np.ones((gw, gh), np.int64)
    points = []
    active = []

    def gidx(p):
        return int(p[0] / cell), int(p[1] / cell)

    def fits(p):
        gx, gy = gidx(p)
        for ix in range(max(gx - 2, 0), min(gx + 3, gw)):
            for iy in range(max(gy - 2, 0), min(gy + 3, gh)):
                j = grid[ix, iy]
                if j >= 0:
                    q = points[j]
                    if (p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 < r * r:
                        return False
        return True

    def add(p):
        points.append(p)
        active.append(len(points) - 1)
        gx, gy = gidx(p)
        grid[gx, gy] = len(points) - 1

    add((rng.uniform(0, width), rng.uniform(0, height)))
    while active:
        i = active[rng.randint(len(active))]
        p = points[i]
        for _ in range(k):
            rad = rng.uniform(r, 2 * r)
            ang = rng.uniform(0, 2 * np.pi)
            q = (p[0] + rad * np.cos(ang), p[1] + rad * np.sin(ang))
            if 0 <= q[0] < width and 0 <= q[1] < height and fits(q):
                add(q)
                break
        else:
            active.remove(i)
    return points


class SceneGenerator:
    """Base random generator holding the asset lists.

    Args:
      envmaps: paths to .pfm HDR environment maps.
      textures: paths to .tga texture images.
      models: paths to .obj geometry files.
      pbrt_converter: path to the ``obj2pbrt`` executable.
    """

    def __init__(self, envmaps, textures, models, pbrt_converter):
        self._envmaps = envmaps
        self._textures = textures
        self._current_textures = []
        self._models = models
        self._converter = ObjConverter(pbrt_converter)
        self._randomize_textures()
        self._log = get_logger(self.__class__.__name__)

    def __str__(self):
        return self.__class__.__name__

    def _randomize_textures(self):
        """Draw a per-scene subset (<= 30) of the texture library."""
        if self._textures:
            self._current_textures = list(np.random.choice(
                self._textures, size=(min(30, len(self._textures)),),
                replace=False))
        else:
            self._current_textures = []


class OutdoorSceneGenerator(SceneGenerator):
    """Random outdoor scene: envmap + ground plane + scattered objects."""

    MAX_OBJECTS = 50

    def _sample_camera(self):
        r_cam = np.random.uniform(1.0, 2.5)
        theta = np.random.uniform(0, 2 * np.pi)
        z_cam = np.random.uniform(0.01, 0.1)
        pos = [r_cam * np.cos(theta), r_cam * np.sin(theta), z_cam]
        target = list(np.random.uniform(0, 1, size=3))
        target[2] = np.random.uniform(1.0, 2.0) * z_cam
        return {
            "position": pos,
            "target": target,
            "up": list(np.random.uniform(size=3)),
            "fov": np.random.uniform(15, 65),
        }

    def _obj_pos(self, cam):
        """Poisson-disc sample object centers inside the camera frustum.

        Returns ``(xy [2, n], scaled_radius, proj)`` with ``proj`` the
        normalized depth along the camera direction.
        """
        factor = 5
        direction = (np.array(cam["target"][:2])
                     - np.array(cam["position"][:2]))
        direction = direction / np.linalg.norm(direction)
        half = 1.1 * cam["fov"] / 180 * np.pi  # +10% for geometry bounds
        c, s = np.cos(half), np.sin(half)
        rot = np.array([[c, -s], [s, c]])
        u1 = factor * np.linalg.inv(rot).dot(direction)
        u2 = factor * rot.dot(direction)
        basis = np.stack([u1, u2], axis=1)

        radius = np.random.uniform(0.13, 0.28)
        scaled_radius = radius * factor

        pts = poisson_disc_samples(1.0, 1.0, radius / factor)
        np.random.shuffle(pts)
        xy = basis.dot(np.array(pts).T)  # [2, n]

        proj = direction.dot(xy)
        keep = np.logical_and(proj > 0.1 * scaled_radius, proj < factor)
        xy = xy[:, keep]
        xy = xy[:, :self.MAX_OBJECTS]

        proj = proj[keep][:self.MAX_OBJECTS]
        if proj.size:
            proj = proj / proj.max()

        xy[0, :] += cam["position"][0]
        xy[1, :] += cam["position"][1]
        return xy, scaled_radius, proj

    def sample(self, scn, dst_dir, params=None):
        """Populate ``scn`` with a random outdoor scene.

        Returns True on success, False when the sampled configuration is
        invalid (caller retries, reference:
        scripts/generate_training_data.py:221-240).
        """
        self._randomize_textures()
        do_dof = bool(np.random.choice([True, False]))
        do_mblur = bool(np.random.choice([True, False]))
        cam = self._sample_camera()
        if do_mblur:
            cam["shutterclose"] = 1.0
        aperture = _random_aperture() if do_dof else 0.0

        coords, radius, _proj = self._obj_pos(cam)
        count = coords.shape[1]
        focus_at = np.random.randint(0, count) if count > 0 else -1
        z_layers = np.random.poisson(0.5) + 1

        # Ground plane (one per scene).
        plane = geometry.Plane(20)
        xforms.rotate(plane, [0, 1, 0], 90)
        floormat = randomizers.random_material(
            id="floormat", textures_list=self._current_textures)
        plane.assign_material(floormat)
        scn.shapes.append(plane)
        scn.materials.append(floormat)

        n_blurred = 0
        for o_idx in range(count):
            this_mblur = do_mblur and bool(np.random.choice([True, False]))
            n_blurred += int(this_mblur)

            mvec_dir = np.random.uniform(size=3)
            mvec = (mvec_dir / np.linalg.norm(mvec_dir)
                    * np.random.uniform(0.0, 2) * radius)

            mdl = np.random.choice(self._models)
            pbrt_objects = self._converter(
                mdl, os.path.join(dst_dir, "geometry"))

            scl = radius * np.random.exponential(0.5) * np.ones(3)
            z_idx = np.random.randint(0, z_layers)
            position = [coords[0, o_idx], coords[1, o_idx],
                        np.random.normal(0.1, 0.2)]

            if do_dof and z_idx == 0 and o_idx == focus_at:
                dist = np.linalg.norm(
                    np.array(cam["position"]) - np.array(position))
                if dist > 0:
                    cam["focaldistance"] = dist
                    cam["lensradius"] = aperture

            # .obj files may contain multiple material groups; add them all.
            for obj in pbrt_objects:
                geom = geometry.ExternalGeometry(
                    os.path.join("geometry", obj.path))
                xforms.rotate(geom, np.random.uniform(size=3),
                              np.random.uniform(0, 360))
                xforms.rotate(geom, np.random.uniform(size=3),
                              np.random.uniform(0, 360))
                xforms.scale(geom, scl)
                xforms.translate(geom, position)
                material = randomizers.random_material(
                    id=obj.material.id,
                    textures_list=self._current_textures)
                scn.materials.append(material)
                if this_mblur:
                    xforms.translate(geom, mvec, target="end")
                scn.shapes.append(geom)

        env = randomizers.random_envmap(self._envmaps, nsamples=8)
        xforms.rotate(env, [0, 0, 1], np.random.uniform(0, 360))
        scn.lights.append(env)

        scn.camera = Camera(**cam)
        self._log.debug("camera %s mblur=%s (%d objects) dof=%s",
                        scn.camera, do_mblur, n_blurred, do_dof)

        if do_mblur and (scn.camera.shutteropen != 0.0
                         or scn.camera.shutterclose != 1.0):
            return False
        if do_dof and not (scn.camera.lensradius > 0.0
                           and scn.camera.focaldistance > 0.0):
            return False
        return True


def _random_aperture(min_=0.001, max_=0.05):
    """Aperture sampled uniformly in the log domain."""
    return float(np.exp(np.random.uniform(np.log(min_), np.log(max_))))
