"""SceneBuilder (counterpart of ``offline_raytracer_tpu/scene/build.py``).

Accumulates materials and primitives on the host with "current material =
last declared" semantics, registers every emissive shape in the NEE light
table, and ``build(device=...)`` freezes it all into the port's ``Scene``
(on the card unless ``device="cpu"`` is passed).
The tables, light table, camera and BVH equal what the JAX builder makes
from the same calls (the tests hold them to it). ``set_sky`` adds what the
JAX package has no counterpart of: a gradient sky that rays reach on a
miss (``scene.types.Sky``).
"""

from __future__ import annotations

import numpy as np
import torch

from offline_raytracer_tpu_torch.ops.bvh import build_tri_bvh
from offline_raytracer_tpu_torch.ops.camera import make_camera
from offline_raytracer_tpu_torch.ops.lights import (
    KIND_CYLINDER, KIND_MESH, KIND_SPHERE, build_area_lights)
from offline_raytracer_tpu_torch.scene.types import (
    Boxes, Cylinders, Materials, Scene, Sky, Spheres, Triangles,
    scene_device)
from offline_raytracer_tpu_torch.utils import profiling
from offline_raytracer_tpu_torch.utils.math import rotation_matrix_to_z


def _box_tris(bmin, bmax):
    """12 outward-facing triangles covering an AABB (12, 3, 3)."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    c = np.array([[x0, y0, z0], [x1, y0, z0], [x0, y1, z0], [x1, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x0, y1, z1], [x1, y1, z1]],
                 np.float32)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    f = []
    for a, b, cc, d in quads:
        f.append([a, b, cc])
        f.append([a, cc, d])
    return c[np.asarray(f)]


class SceneBuilder:
    def __init__(self):
        # material 0 is the default material
        self._mat = {
            "diffuse": [[0.0, 0.0, 0.0]], "specular": [[0.0, 0.0, 0.0]],
            "spec_exp": [1.0], "transmission": [[0.0, 0.0, 0.0]],
            "ior": [1.0], "emit": [[0.0, 0.0, 0.0]], "is_light": [False],
        }
        self._spheres = []     # (center, r, mat)
        self._boxes = []       # (bmin, bmax, mat)
        self._cylinders = []   # (base, axis, r, mat)
        self._tri_v = []       # (n, 3, 3) vertex blocks
        self._tri_m = []       # per-block materials
        self._lights = []      # AreaLights entries
        self.ambient = np.zeros(3, np.float32)
        self.sky = None        # (bottom, top, up) float32 arrays
        self.camera_p = np.array([0.0, 0.0, 1.0], np.float32)
        self.camera_height_ratio = 0.5
        self.camera_quat = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        self.width = 400
        self.height = 300

    # ---- materials -----------------------------------------------------
    def add_material(self, diffuse=(0, 0, 0), specular=(0, 0, 0),
                     spec_exp=1.0, transmission=(0, 0, 0), ior=1.0) -> int:
        m = self._mat
        m["diffuse"].append(list(diffuse))
        m["specular"].append(list(specular))
        m["spec_exp"].append(float(spec_exp))
        m["transmission"].append(list(transmission))
        m["ior"].append(float(ior))
        m["emit"].append([0.0, 0.0, 0.0])
        m["is_light"].append(False)
        return len(m["ior"]) - 1

    def add_light_material(self, emit) -> int:
        m = self._mat
        m["diffuse"].append([0.0, 0.0, 0.0])
        m["specular"].append([0.0, 0.0, 0.0])
        m["spec_exp"].append(1.0)
        m["transmission"].append([0.0, 0.0, 0.0])
        m["ior"].append(1.0)
        m["emit"].append(list(emit))
        m["is_light"].append(True)
        return len(m["ior"]) - 1

    @property
    def current_mat(self) -> int:
        return len(self._mat["ior"]) - 1

    def _is_light(self, mat: int) -> bool:
        return bool(self._mat["is_light"][mat])

    # ---- primitives ----------------------------------------------------
    def add_sphere(self, center, radius, mat=None):
        mat = self.current_mat if mat is None else mat
        self._spheres.append(
            (np.asarray(center, np.float32), float(radius), mat))
        if self._is_light(mat):
            self._lights.append(dict(
                kind=KIND_SPHERE, mat=mat,
                p0=np.asarray(center, np.float32), radius=float(radius)))

    def add_box(self, bmin, extent, mat=None):
        """Box from min corner + extents (the .scn ``box`` encoding)."""
        mat = self.current_mat if mat is None else mat
        bmin = np.asarray(bmin, np.float32)
        self.add_box_minmax(bmin, bmin + np.asarray(extent, np.float32), mat)

    def add_box_minmax(self, bmin, bmax, mat=None):
        mat = self.current_mat if mat is None else mat
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        self._boxes.append((bmin, bmax, mat))
        # emissive boxes are NEE-sampled as 12-triangle meshes; their
        # intersection stays the analytic box
        if self._is_light(mat):
            self._lights.append(dict(
                kind=KIND_MESH, mat=mat, tris=_box_tris(bmin, bmax)))

    def add_cylinder(self, base, axis, radius, mat=None):
        mat = self.current_mat if mat is None else mat
        self._cylinders.append(
            (np.asarray(base, np.float32), np.asarray(axis, np.float32),
             float(radius), mat))
        if self._is_light(mat):
            self._lights.append(dict(
                kind=KIND_CYLINDER, mat=mat,
                p0=np.asarray(base, np.float32),
                axis=np.asarray(axis, np.float32), radius=float(radius),
                rot=rotation_matrix_to_z(axis)))

    def add_triangles(self, vertices, indices, mat=None):
        """vertices (V, 3), indices (F, 3) int — appended as one block."""
        mat = self.current_mat if mat is None else mat
        v = np.asarray(vertices, np.float32)
        f = np.asarray(indices, np.int64)
        self._tri_v.append(v[f])
        self._tri_m.append(np.full((f.shape[0],), mat, np.int32))
        if self._is_light(mat):
            self._lights.append(dict(kind=KIND_MESH, mat=mat, tris=v[f]))

    # ---- camera --------------------------------------------------------
    def set_camera(self, p, height_ratio, quat_xyzw):
        self.camera_p = np.asarray(p, np.float32)
        self.camera_height_ratio = float(height_ratio)
        self.camera_quat = np.asarray(quat_xyzw, np.float32)

    # ---- sky -----------------------------------------------------------
    def set_sky(self, bottom, top, up=(0.0, 0.0, 1.0)):
        """A miss reaches (1 - a) bottom + a top, a = (d.up + 1) / 2."""
        up = np.asarray(up, np.float64)
        self.sky = (np.asarray(bottom, np.float32),
                    np.asarray(top, np.float32),
                    (up / np.linalg.norm(up)).astype(np.float32))

    # ---- build ---------------------------------------------------------
    @profiling.spanned("scene.build")
    def build(self, width=None, height=None, bvh_leaf_size: int = 128,
              with_bvh: bool = True, device="cuda") -> Scene:
        device = scene_device(device)
        W = self.width if width is None else width
        H = self.height if height is None else height
        t = torch.from_numpy

        m = self._mat
        materials = Materials(
            diffuse=t(np.asarray(m["diffuse"], np.float32)),
            specular=t(np.asarray(m["specular"], np.float32)),
            spec_exp=t(np.asarray(m["spec_exp"], np.float32)),
            transmission=t(np.asarray(m["transmission"], np.float32)),
            ior=t(np.asarray(m["ior"], np.float32)),
            emit=t(np.asarray(m["emit"], np.float32)),
            is_light=t(np.asarray(m["is_light"], bool)),
        )

        def stack(items, idx, shape):
            if not items:
                return np.zeros((0,) + shape, np.float32)
            return np.stack([np.asarray(it[idx], np.float32) for it in items])

        def mats(items, idx):
            return t(np.asarray([it[idx] for it in items], np.int32))

        spheres = Spheres(center=t(stack(self._spheres, 0, (3,))),
                          radius=t(stack(self._spheres, 1, ())),
                          mat=mats(self._spheres, 2))
        boxes = Boxes(bmin=t(stack(self._boxes, 0, (3,))),
                      bmax=t(stack(self._boxes, 1, (3,))),
                      mat=mats(self._boxes, 2))
        rots = (np.stack([rotation_matrix_to_z(c[1]) for c in self._cylinders])
                if self._cylinders else np.zeros((0, 3, 3), np.float32))
        cylinders = Cylinders(base=t(stack(self._cylinders, 0, (3,))),
                              axis=t(stack(self._cylinders, 1, (3,))),
                              radius=t(stack(self._cylinders, 2, ())),
                              rot=t(rots), mat=mats(self._cylinders, 3))
        if self._tri_v:
            tv = np.concatenate(self._tri_v, 0)
            tm = np.concatenate(self._tri_m, 0)
        else:
            tv = np.zeros((0, 3, 3), np.float32)
            tm = np.zeros((0,), np.int32)
        triangles = Triangles(
            v0=t(np.ascontiguousarray(tv[:, 0])),
            v1=t(np.ascontiguousarray(tv[:, 1])),
            v2=t(np.ascontiguousarray(tv[:, 2])), mat=t(tm))
        lights = build_area_lights(self._lights)
        mat_to_light = np.full((len(m["ior"]),), -1, np.int32)
        for li, entry in enumerate(self._lights):
            mat_to_light[entry["mat"]] = li

        camera = make_camera(self.camera_p, self.camera_height_ratio,
                             self.camera_quat, W, H)
        tri_bvh = None
        if with_bvh and tv.shape[0] > 0:
            tri_bvh = build_tri_bvh(tv[:, 0], tv[:, 1], tv[:, 2], tm,
                                    leaf_size=bvh_leaf_size)
        sky = None
        if self.sky is not None:
            sky = Sky(*(t(x.copy()) for x in self.sky))
        scene = Scene(
            materials=materials, spheres=spheres, boxes=boxes,
            cylinders=cylinders, triangles=triangles, lights=lights,
            camera=camera, ambient=t(self.ambient.copy()),
            mat_to_light=t(mat_to_light), tri_bvh=tri_bvh, sky=sky)
        return scene.to(device)
