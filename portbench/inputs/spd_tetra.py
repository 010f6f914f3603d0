"""The Sierpinski pyramid of Haines's SPD ``tetra`` as a mesh.

Eric Haines, Standard Procedural Databases (SPD), generator ``tetra.c``
("A Proposal for Standard Graphics Environments", IEEE CG&A 7(11), 1987):
a tetrahedron replaced by the four half-size tetrahedra at its corners,
``size_factor`` times over, 4**size_factor tetrahedra of four triangles
each. The root tetrahedron has an equilateral base of edge 2 on z = 0,
centred on the origin, and its apex at z = 2 sqrt(2/3).

Frozen copy of ``spd_tetra`` of ``offline_raytracer_tpu_torch/scene/
procedural.py`` at commit 356a876 (where it was first written), so that
the benchmark's mesh does not move with the program's generator. A
configuration names it by its ``spd_tetra`` key, ``{"size_factor": n}``;
``mesh_call`` is the builder call the ``wavefront_bvh`` loop appends to
the recipe's calls.
"""

from __future__ import annotations

import numpy as np

_BASE = np.array([[-1.0, -1.0 / np.sqrt(3.0), 0.0],
                  [1.0, -1.0 / np.sqrt(3.0), 0.0],
                  [0.0, 2.0 / np.sqrt(3.0), 0.0]])
_APEX = np.array([0.0, 0.0, 2.0 * np.sqrt(2.0 / 3.0)])
# faces over a tetrahedron's corners (a, b, c, d), wound outward
_FACES = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]], np.int32)


def spd_tetra(size_factor: int):
    """(vertices (4 * 4**size_factor, 3) float32, faces (4 *
    4**size_factor, 3) int32), in the recursion's order."""
    sf = int(size_factor)
    if sf < 0:
        raise ValueError(f"size_factor must be >= 0, got {size_factor}")
    corners = np.concatenate([_BASE, _APEX[None]], 0)
    edges = corners - corners[0]
    origin = corners[:1]
    for level in range(1, sf + 1):
        origin = (origin[:, None, :]
                  + edges[None, :, :] / 2.0 ** level).reshape(-1, 3)
    verts = origin[:, None, :] + edges[None, :, :] / 2.0 ** sf
    n = origin.shape[0]
    faces = (_FACES[None, :, :]
             + 4 * np.arange(n, dtype=np.int32)[:, None, None])
    return (verts.reshape(-1, 3).astype(np.float32),
            faces.reshape(-1, 3).astype(np.int32))


def mesh_call(spec: dict):
    """The ``add_triangles`` call of a configuration's ``spd_tetra``
    entry, as ``inputs/recipe.calls`` gives its calls."""
    return ("add_triangles", spd_tetra(int(spec["size_factor"])))
