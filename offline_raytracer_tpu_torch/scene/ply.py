"""ASCII PLY loader (counterpart of ``offline_raytracer_tpu/scene/ply.py``).

The Python path of the JAX package's loader: reads x, y, z, skips extra
vertex properties, and expands n-gon faces into triangle fans.
"""

from __future__ import annotations

import numpy as np


def load_ply(path: str):
    """Returns (vertices (V, 3) float32, indices (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()

    end_tag = b"end_header"
    hdr_end = data.index(end_tag)
    header = data[:hdr_end].decode("ascii", "replace")
    body = data[data.index(b"\n", hdr_end) + 1:]

    n_vert = n_face = 0
    n_vert_props = 0
    current = None
    fmt = None
    for line in header.splitlines():
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "format":
            fmt = toks[1]
        elif toks[0] == "element":
            current = toks[1]
            if current == "vertex":
                n_vert = int(toks[2])
            elif current == "face":
                n_face = int(toks[2])
        elif toks[0] == "property" and current == "vertex":
            if toks[1] != "list":
                n_vert_props += 1
    if fmt != "ascii":
        raise ValueError(f"only ascii PLY supported (got {fmt})")

    tokens = body.split()
    nv_tok = n_vert * n_vert_props
    verts = np.array(tokens[:nv_tok], np.float32).reshape(
        n_vert, n_vert_props)[:, :3]

    face_toks = np.array(tokens[nv_tok:], np.int64)
    if face_toks.size == n_face * 4 and (face_toks[::4] == 3).all():
        return np.ascontiguousarray(verts), (
            face_toks.reshape(n_face, 4)[:, 1:].astype(np.int32))
    tris = []
    pos = 0
    for _ in range(n_face):
        k = int(face_toks[pos])
        idx = face_toks[pos + 1: pos + 1 + k]
        pos += 1 + k
        if k == 3:
            tris.append(idx[None, :])
        else:
            fan = np.stack(
                [np.full(k - 2, idx[0]), idx[1: k - 1], idx[2:k]], axis=1)
            tris.append(fan)
    indices = (np.concatenate(tris).astype(np.int32) if tris
               else np.zeros((0, 3), np.int32))
    return np.ascontiguousarray(verts), indices
