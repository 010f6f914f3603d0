"""Scene presets (counterpart of ``offline_raytracer_tpu/models/scenes.py``).

One constructor per configuration, so tests, chip runs and the CLI share
identical scenes:

  analytic()    sphere + floor + sphere light (needs no data)
  letter()      letterX.ply + letterY.ply, diffuse
  bunny()       bunny.ply + floor + area light
  dwarf()       dwarf.obj, shaped lights
  testscene()   testscene.scn, a full multi-object scene
  spd_tetra()   Haines's SPD tetra: a Sierpinski pyramid under a sky and
                one sphere light (needs no data)

The mesh presets read their files from ``data_dir`` (by default ``data/``
at the repository root). Every preset builds on the card unless
``device="cpu"`` is passed. ``preset`` builds one by name at its own size.
"""

from __future__ import annotations

import inspect
import os

import numpy as np

from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.scene.obj import load_obj
from offline_raytracer_tpu_torch.scene.procedural import spd_tetra as tetra
from offline_raytracer_tpu_torch.scene.ply import load_ply
from offline_raytracer_tpu_torch.scene.scn import load_scene
from offline_raytracer_tpu_torch.scene.types import scene_device

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data")


def _lookat_quat_y(angle=np.pi / 2):
    """Quaternion (xyzw) rotating the default camera frame about +Y."""
    h = angle / 2
    return np.array([0.0, np.sin(h), 0.0, np.cos(h)], np.float32)


def analytic(width=256, height=256, device="cuda"):
    """Single sphere + floor box + one sphere light."""
    b = SceneBuilder()
    b.add_material(diffuse=(0.7, 0.3, 0.2))
    b.add_sphere((0.0, 0.0, 1.0), 0.8)
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-20, -20, -0.2), (20, 20, 0.0))
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((2.0, -2.0, 4.0), 0.5)
    b.set_camera((4.0, 0.0, 1.5), 0.4, _lookat_quat_y())
    return b.build(width, height, device=device)


def letter(width=256, height=256, data_dir=DATA_DIR, device="cuda"):
    """letterX + letterY plies, diffuse."""
    device = scene_device(device)
    vx, fx = load_ply(os.path.join(data_dir, "letterX.ply"))
    vy, fy = load_ply(os.path.join(data_dir, "letterY.ply"))
    b = SceneBuilder()
    b.add_material(diffuse=(0.8, 0.2, 0.2))
    b.add_triangles(vx + np.array([-1.2, 0, 1.5], np.float32), fx)
    b.add_material(diffuse=(0.2, 0.2, 0.8))
    b.add_triangles(vy + np.array([1.2, 0, 1.5], np.float32), fy)
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-20, -20, -0.4), (20, 20, -0.2))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((0.0, -3.0, 5.0), 0.6)
    b.set_camera((0.0, -6.0, 1.5), 0.4,
                 np.array([np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)],
                          np.float32))
    return b.build(width, height, device=device)


def bunny_builder(v, f) -> SceneBuilder:
    """The bunny configuration around any mesh (v (V,3), f (F,3)): the mesh
    recentred, scaled by 8 and set on the floor, with the bunny preset's
    materials, floor, light and camera."""
    v = (np.asarray(v, np.float32) - v.mean(0)) * 8.0
    v[:, 2] -= v[:, 2].min()
    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.5, 0.4), specular=(0.3, 0.3, 0.3),
                   spec_exp=50)
    b.add_triangles(v, f)
    b.add_material(diffuse=(0.4, 0.4, 0.45))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    b.set_camera((2.5, 0.0, 0.8), 0.4, _lookat_quat_y())
    return b


def bunny(width=512, height=512, data_dir=DATA_DIR, leaf_size=128,
          device="cuda"):
    """bunny.ply + floor + area light (NEE exercised)."""
    device = scene_device(device)
    v, f = load_ply(os.path.join(data_dir, "bunny.ply"))
    return bunny_builder(v, f).build(width, height, bvh_leaf_size=leaf_size,
                                     device=device)


def dwarf(width=512, height=512, data_dir=DATA_DIR, device="cuda"):
    """dwarf.obj, two shaped lights."""
    device = scene_device(device)
    o = load_obj(os.path.join(data_dir, "dwarf.obj"))
    v = (o["positions"] - o["positions"].mean(0)) * 0.02
    # the obj is y-up and the scene z-up: (x, y, z) -> (x, -z, y), a proper
    # rotation, so the model stays upright and right-handed
    y = v[:, 1].copy()
    v[:, 1] = -v[:, 2]
    v[:, 2] = y
    v[:, 2] -= v[:, 2].min()
    b = SceneBuilder()
    b.add_material(diffuse=(0.7, 0.55, 0.35), specular=(0.2, 0.2, 0.2),
                   spec_exp=30)
    b.add_triangles(v, o["indices"])
    b.add_material(diffuse=(0.45, 0.45, 0.5))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((12.0, 11.0, 9.0))
    b.add_sphere((1.5, -1.5, 2.5), 0.35)
    b.add_light_material((3.0, 3.5, 5.0))
    b.add_sphere((-1.5, 1.5, 3.0), 0.5)
    # camera on +X looking at the origin with image-up = world +Z: the
    # cyclic axis permutation x->y->z->x, 120 degrees about (1, 1, 1)
    b.set_camera((2.6, 0.0, 0.9), 0.4,
                 np.array([0.5, 0.5, 0.5, 0.5], np.float32))
    return b.build(width, height, device=device)


def testscene(width=None, height=None, data_dir=DATA_DIR, device="cuda",
              with_size=False):
    """testscene.scn, at its own ``screen`` size unless width/height are
    given; with ``with_size`` -> (scene, (W, H))."""
    scene, size = load_scene(os.path.join(data_dir, "testscene.scn"),
                             width, height, device=device)
    return (scene, size) if with_size else scene


# SPD's background colour, a constant sky here
SPD_SKY = (0.078, 0.361, 0.753)
# the pyramid's material on the three-lobe BSDF
SPD_MATERIAL = dict(diffuse=(0.8, 0.8, 0.8), specular=(0.2, 0.2, 0.2),
                    spec_exp=100.0)
# a white sphere light for SPD's point light; at the pyramid's centroid
# (0, 0, sqrt(2/3) / 2), 5 away, its irradiance is the sky's by the mean of
# the sky's channels: emission mean(sky) * (5 / 0.25)**2
SPD_LIGHT_CENTER = (-0.498003, -2.824313, 4.504009)
SPD_LIGHT_RADIUS = 0.25
SPD_LIGHT_EMIT = (158.933333, 158.933333, 158.933333)
# a pinhole 3/4 view from above, looking from azimuth -50 degrees and
# elevation 28 degrees at (-0.25, -0.1, 0.5) from 5.5 away, image-up
# nearest world +Z: the pyramid spans ~75% of the image height
SPD_CAMERA_P = (2.8715127498075037, -3.8200740339117236, 3.0820935953223993)
SPD_CAMERA_HEIGHT_RATIO = 0.27
SPD_CAMERA_QUAT = (0.4839774784167579, 0.17615339619891326,
                   0.2931684830402131, 0.8054737872487507)


def spd_tetra(width=512, height=512, size_factor=8, device="cuda"):
    """Haines's SPD tetra at ``size_factor`` (8: 262,144 triangles in 2,048
    leaves) under a constant sky and one sphere light: the wavefront route
    (the sky keeps it off the segment kernel), its triangle queries and
    NEE."""
    device = scene_device(device)
    b = SceneBuilder()
    b.add_light_material(SPD_LIGHT_EMIT)
    b.add_sphere(SPD_LIGHT_CENTER, SPD_LIGHT_RADIUS)
    b.add_material(**SPD_MATERIAL)
    b.add_triangles(*tetra(size_factor))
    b.set_camera(SPD_CAMERA_P, SPD_CAMERA_HEIGHT_RATIO,
                 np.asarray(SPD_CAMERA_QUAT, np.float32))
    b.set_sky(SPD_SKY, SPD_SKY)
    return b.build(width, height, device=device)


BY_NAME = {
    "analytic": analytic,
    "letter": letter,
    "bunny": bunny,
    "dwarf": dwarf,
    "testscene": testscene,
    "spd_tetra": spd_tetra,
}


def preset(name: str, width=None, height=None, device="cuda"):
    """Preset ``name`` -> (Scene, (W, H)), at the preset's own default size
    where width or height is None (testscene: its file's ``screen``)."""
    fn = BY_NAME[name]
    if name == "testscene":
        return fn(width, height, device=device, with_size=True)
    sig = inspect.signature(fn).parameters
    w = sig["width"].default if width is None else width
    h = sig["height"].default if height is None else height
    return fn(w, h, device=device), (w, h)
