"""Wavefront OBJ loader (counterpart of ``offline_raytracer_tpu/scene/obj.py``,
numpy).

The Python path of the JAX package's loader: ``v``, ``vn``, ``vt`` and ``f``
lines with the face formats ``v``, ``v//vn``, ``v/vt/vn`` (and ``v/vt``),
n-gons triangulated as fans, 1-based and negative (relative) indices
resolved to 0-based.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns a dict: positions (V, 3) float32, indices (F, 3) int32 into
    positions, and normals (Vn, 3) / texcoords (Vt, 2) float32 with their
    parallel normal_indices / texcoord_indices, or None where the faces
    name none."""
    positions, normals, texcoords = [], [], []
    f_pos, f_nrm, f_tex = [], [], []

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            tag = toks[0]
            if tag == "v":
                positions.append([float(toks[1]), float(toks[2]),
                                  float(toks[3])])
            elif tag == "vn":
                normals.append([float(toks[1]), float(toks[2]),
                                float(toks[3])])
            elif tag == "vt":
                texcoords.append([float(toks[1]), float(toks[2])])
            elif tag == "f":
                corners = [_parse_corner(t) for t in toks[1:]]
                for j in range(1, len(corners) - 1):     # fan
                    tri = (corners[0], corners[j], corners[j + 1])
                    f_pos.append([c[0] for c in tri])
                    f_tex.append([c[1] for c in tri])
                    f_nrm.append([c[2] for c in tri])

    def resolve(raw, count):
        """1-based, negative counting back from the end; a corner that
        names no index (None) gets 0, as the JAX package's native parser
        gives it."""
        idx = np.asarray([[1 if c is None else c for c in tri] for tri in raw],
                         np.int64).reshape(-1, 3)
        return np.where(idx > 0, idx - 1, idx + count).astype(np.int32)

    out = {
        "positions": np.asarray(positions, np.float32).reshape(-1, 3),
        "indices": resolve(f_pos, len(positions)),
        "normals": None, "normal_indices": None,
        "texcoords": None, "texcoord_indices": None,
    }
    if normals and any(c is not None for tri in f_nrm for c in tri):
        out["normals"] = np.asarray(normals, np.float32).reshape(-1, 3)
        out["normal_indices"] = resolve(f_nrm, len(normals))
    if texcoords and any(c is not None for tri in f_tex for c in tri):
        out["texcoords"] = np.asarray(texcoords, np.float32).reshape(-1, 2)
        out["texcoord_indices"] = resolve(f_tex, len(texcoords))
    return out


def _parse_corner(tok: str):
    """'7', '7//2', '7/5/2', '7/5' -> (pos, tex, nrm), raw, None if absent."""
    parts = tok.split("/")
    pos = int(parts[0])
    tex = int(parts[1]) if len(parts) > 1 and parts[1] else None
    nrm = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return pos, tex, nrm
