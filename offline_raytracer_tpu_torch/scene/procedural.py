"""Procedural geometry: meshes made by a rule, with no file to read.

``spd_tetra`` is the tetrahedral pyramid of Sierpinski from Eric Haines's
Standard Procedural Databases (SPD, generator ``tetra.c``; "A Proposal for
Standard Graphics Environments", IEEE CG&A 7(11), 1987): a tetrahedron
replaced by the four half-size tetrahedra at its corners, ``size_factor``
times over. The sub-tetrahedra touch only at vertices, so no two faces
coincide.
"""

from __future__ import annotations

import numpy as np

# the root tetrahedron: an equilateral base of edge 2 on z = 0, centred on
# the origin and counter-clockwise seen from above, and the apex above its
# centre, every edge 2 long
_BASE = np.array([[-1.0, -1.0 / np.sqrt(3.0), 0.0],
                  [1.0, -1.0 / np.sqrt(3.0), 0.0],
                  [0.0, 2.0 / np.sqrt(3.0), 0.0]])
_APEX = np.array([0.0, 0.0, 2.0 * np.sqrt(2.0 / 3.0)])
# a tetrahedron's faces over its corners (a, b, c, d), wound so that
# (v1 - v0) x (v2 - v0) points out of it: the base, then the three sides
_FACES = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]], np.int32)


def spd_tetra(size_factor: int):
    """(vertices (4 * 4**size_factor, 3) float32, faces (4 *
    4**size_factor, 3) int32) of the Sierpinski pyramid: 4**size_factor
    tetrahedra of edge 2 / 2**size_factor, four vertices and four
    outward-wound faces each, in the recursion's order (the first
    subdivision's corner is the slowest-varying index)."""
    sf = int(size_factor)
    if sf < 0:
        raise ValueError(f"size_factor must be >= 0, got {size_factor}")
    corners = np.concatenate([_BASE, _APEX[None]], 0)
    edges = corners - corners[0]
    # each tetrahedron's first corner: the root's, plus a corner's edge at
    # every level of the recursion, halved level by level
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
