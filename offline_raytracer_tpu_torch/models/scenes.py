"""Scene presets (counterpart of ``offline_raytracer_tpu/models/scenes.py``).

``analytic`` needs no data; ``bunny`` reads ``bunny.ply`` from ``data_dir``
(by default ``data/`` at the repository root). Both build on the card
unless ``device="cpu"`` is passed. The letter, dwarf and testscene presets
wait until their data files are in the repository.
"""

from __future__ import annotations

import os

import numpy as np

from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.scene.ply import load_ply
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

