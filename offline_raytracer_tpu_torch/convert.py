"""Scene tables handed over from the JAX package as numpy arrays.

``scene_from_arrays`` takes the leaves of a JAX ``Scene`` pytree, keyed by
their pytree paths as ``jax.tree_util.keystr`` writes them (for example
``.materials.diffuse`` or ``.tri_bvh.planes``; the leading dot is
optional), and returns the port's ``Scene`` with the same values, shapes
and dtypes on ``device`` (the card unless ``device="cpu"`` is passed).
The caller flattens the JAX scene, so this package needs no jax. The BVH's
static ``m_occ`` and ``n_leaves`` are not pytree leaves; they are
recovered from the leaf bounds. The sub-leaf boxes, which the JAX BVH does
not hold, are built here from the triangles the BVH was built from.
A JAX scene has no sky; the optional leaves ``.sky.bottom``, ``.sky.top``
and ``.sky.up`` give the port's (``scene.types.Sky``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.ops.bvh import (
    TriBVH, heap_leaf_count, sub_bounds_rows)
from offline_raytracer_tpu_torch.ops.lights import AreaLights
from offline_raytracer_tpu_torch.scene.types import (
    Boxes, Camera, Cylinders, Materials, Scene, Sky, Spheres, Triangles,
    scene_device)

_TABLES = {
    "materials": Materials, "spheres": Spheres, "boxes": Boxes,
    "cylinders": Cylinders, "triangles": Triangles, "lights": AreaLights,
    "camera": Camera,
}


def scene_from_arrays(arrays: dict, device="cuda") -> Scene:
    """{pytree path: np.ndarray} of a JAX Scene -> the port's Scene."""
    device = scene_device(device)
    tree: dict = {}
    for key, value in arrays.items():
        parts = key.lstrip(".").split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(value, copy=True))

    def table(cls, fields: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(fields) - names
        if unknown:
            raise KeyError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
        return cls(**fields)

    kw = {name: table(cls, tree.pop(name)) for name, cls in _TABLES.items()}
    if "sky" in tree:
        kw["sky"] = table(Sky, tree.pop("sky"))
    bvh = tree.pop("tri_bvh", None)
    if bvh is not None:
        lb = bvh["leaf_bounds"]
        m_occ = int(torch.isfinite(lb[0]).sum())
        tri = kw["triangles"]
        sub = sub_bounds_rows(bvh["tri_index"].numpy(), tri.v0.numpy(),
                              tri.v1.numpy(), tri.v2.numpy())
        bvh = TriBVH(**bvh, sub_bounds=torch.from_numpy(sub),
                     n_leaves=heap_leaf_count(m_occ), m_occ=m_occ)
    scene = Scene(**kw, ambient=tree.pop("ambient"),
                  mat_to_light=tree.pop("mat_to_light"), tri_bvh=bvh)
    if tree:
        raise KeyError(f"unknown scene leaves {sorted(tree)}")
    return scene.to(device)
