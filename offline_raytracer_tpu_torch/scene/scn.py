""".scn scene-description parser (counterpart of
``offline_raytracer_tpu/scene/scn.py``, numpy).

The grammar of the reference renderer's scene files:

    screen W H
    camera x y z  b height_ratio  q w x y z
    ambient r g b
    light r g b                      -> an emissive material becomes current
    brdf dr dg db  sr sg sb exp  [tr tg tb ior]
    sphere x y z r
    box bx by bz  dx dy dz           (min corner + extents)
    cylinder bx by bz  ax ay az  r
    mesh file  tx ty tz  s  [z deg]  q w x y z

Each primitive takes the last declared material. Quaternions are written
w x y z in the file and stored xyzw. Meshes are ``.ply`` (``scene/ply.py``)
or ``.obj`` (``scene/obj.py``); their paths are relative to the ``.scn``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.scene.obj import load_obj
from offline_raytracer_tpu_torch.scene.ply import load_ply

DEG_TO_RAD = 0.0174533  # the reference renderer's constant


@dataclasses.dataclass
class MeshInfo:
    path: str
    translate: np.ndarray
    scale: float
    z_degree: float          # rotation about the *Y* axis
    quaternion: np.ndarray   # xyzw
    mat: int


def parse_scn(text: str):
    """Parse .scn text -> (SceneBuilder, [MeshInfo], (width, height))."""
    toks = text.split()
    pos = 0
    b = SceneBuilder()
    meshes: list[MeshInfo] = []
    size = (b.width, b.height)

    def nf():
        nonlocal pos
        v = float(toks[pos])
        pos += 1
        return v

    def ni():
        nonlocal pos
        v = int(float(toks[pos]))
        pos += 1
        return v

    def expect(marker):
        nonlocal pos
        if toks[pos] != marker:
            raise ValueError(f".scn: expected '{marker}' at token {pos}, "
                             f"got {toks[pos]!r}")
        pos += 1

    def is_number(t):
        try:
            float(t)
            return True
        except ValueError:
            return False

    while pos < len(toks):
        kw = toks[pos]
        pos += 1
        if kw == "screen":
            size = (ni(), ni())
        elif kw == "camera":
            p = (nf(), nf(), nf())
            expect("b")
            hr = nf()
            expect("q")
            w, x, y, z = nf(), nf(), nf(), nf()
            b.set_camera(p, hr, (x, y, z, w))
        elif kw == "ambient":
            b.ambient = np.array([nf(), nf(), nf()], np.float32)
        elif kw == "light":
            b.add_light_material((nf(), nf(), nf()))
        elif kw == "brdf":
            kd = (nf(), nf(), nf())
            ks = (nf(), nf(), nf())
            exp = nf()
            if pos < len(toks) and is_number(toks[pos]):   # transmission
                kt = (nf(), nf(), nf())
                ior = nf()
            else:
                kt, ior = (0.0, 0.0, 0.0), 1.0
            b.add_material(diffuse=kd, specular=ks, spec_exp=exp,
                           transmission=kt, ior=ior)
        elif kw == "sphere":
            b.add_sphere((nf(), nf(), nf()), nf())
        elif kw == "box":
            b.add_box((nf(), nf(), nf()), (nf(), nf(), nf()))
        elif kw == "cylinder":
            b.add_cylinder((nf(), nf(), nf()), (nf(), nf(), nf()), nf())
        elif kw == "mesh":
            fname = toks[pos]
            pos += 1
            tr = np.array([nf(), nf(), nf()], np.float32)
            scale = nf()
            zdeg = 0.0
            if toks[pos] == "z":
                pos += 1
                zdeg = nf()
            expect("q")
            w, x, y, z = nf(), nf(), nf(), nf()
            meshes.append(MeshInfo(
                path=fname, translate=tr, scale=scale, z_degree=zdeg,
                quaternion=np.array([x, y, z, w], np.float32),
                mat=b.current_mat))
        else:
            raise ValueError(f".scn: unknown keyword {kw!r}")

    return b, meshes, size


def transform_mesh_vertices(verts: np.ndarray, info: MeshInfo) -> np.ndarray:
    """scale -> rotate about Y by z_degree -> rotate by the quaternion ->
    translate."""
    v = verts * info.scale
    rad = DEG_TO_RAD * info.z_degree
    c, s = np.cos(rad), np.sin(rad)
    # rotation about Y: x' = c x + s z ; z' = -s x + c z
    v = np.stack([c * v[:, 0] + s * v[:, 2], v[:, 1],
                  -s * v[:, 0] + c * v[:, 2]], axis=1)
    q = info.quaternion.astype(np.float64)
    qv, w = q[:3], q[3]
    t = 2.0 * np.cross(np.broadcast_to(qv, v.shape), v)
    v = v + w * t + np.cross(np.broadcast_to(qv, t.shape), t)
    return (v + info.translate).astype(np.float32)


def load_scene(path: str, width=None, height=None, device="cuda"):
    """A .scn file and its meshes -> (Scene on ``device``, (W, H)); W and H
    are the file's ``screen`` unless given."""
    with open(path) as f:
        text = f.read()
    builder, mesh_infos, size = parse_scn(text)
    base = os.path.dirname(os.path.abspath(path))

    for info in mesh_infos:
        fpath = os.path.join(base, info.path)
        ext = os.path.splitext(fpath)[1].lower()
        if ext == ".ply":
            verts, idx = load_ply(fpath)
        elif ext == ".obj":
            o = load_obj(fpath)
            verts, idx = o["positions"], o["indices"]
        else:
            raise ValueError(f"unsupported mesh format: {fpath}")
        builder.add_triangles(transform_mesh_vertices(verts, info), idx,
                              mat=info.mat)

    W = size[0] if width is None else width
    H = size[1] if height is None else height
    return builder.build(W, H, device=device), (W, H)
