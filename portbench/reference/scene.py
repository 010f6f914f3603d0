"""The reference's scene: raw builder calls -> the tables its tracer reads.

Frozen copies, at commit 7999567 (last changed in c7b6d06), of what the
reference needs from the port's host-side scene code, recomputed here
from the raw arrays of a recipe (``portbench/inputs/recipe.py``):

- ``SceneArrays``: the accumulation of ``scene/build.SceneBuilder`` (the
  current material is the last declared; every emissive shape is a light,
  an emissive box a 12-triangle mesh light);
- ``rotation_matrix_to_z`` (``utils/math.py``), ``triangle_coefficients``
  (``ops/bvh.py``), ``build_area_lights`` (``ops/lights.py``) and
  ``make_camera`` (``ops/camera.py``);
- ``RefScene.consts``: the per-primitive rows of ``ops/mega.pack_consts``.

No BVH: the reference sweeps every triangle, in the order the recipe
gives them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

KIND_SPHERE, KIND_CYLINDER, KIND_MESH = 0, 1, 2
INF = 3.4e38
PARK = 1e8
LANE = 128
# first rows of each table in RefScene.consts (ops/mega.MegaMeta's layout)
SPH, BOX, CYL, MAT, LGT = 0, 5, 12, 27, 45


def rotation_matrix_to_z(axis):
    """Rotation matrix (rows) mapping ``axis`` to +Z."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    z = np.array([0.0, 0.0, 1.0])
    c = np.cross(z, a)
    if np.linalg.norm(c) < 1e-9:
        b = np.cross(np.array([1.0, 0.0, 0.0]), a)
        if np.linalg.norm(b) < 1e-9:
            b = np.cross(np.array([0.0, 1.0, 0.0]), a)
    else:
        b = c
    b = b / np.linalg.norm(b)
    cc = np.cross(a, b)
    return np.stack([b, cc, a]).astype(np.float32)


def triangle_coefficients(v0, v1, v2):
    """(N,3) x3 -> (N, 12) affine-barycentric rows (s1, c1, s2, c2, n, cw):
    t = -(n.o + cw) / (n.d), u = (s1.o + c1) + t (s1.d), v likewise."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    e2xn = np.cross(e2, n)
    e1xn = np.cross(e1, n)
    d1 = np.sum(e1 * e2xn, -1)
    d2 = np.sum(e2 * e1xn, -1)
    ok = (np.abs(d1) > 1e-30) & (np.abs(d2) > 1e-30)
    safe1 = np.where(ok, d1, 1.0)[:, None]
    safe2 = np.where(ok, d2, 1.0)[:, None]
    s1 = np.where(ok[:, None], e2xn / safe1, 0.0)
    s2 = np.where(ok[:, None], e1xn / safe2, 0.0)
    n = np.where(ok[:, None], n, 0.0)
    c1 = -np.sum(s1 * v0, -1)
    c2 = -np.sum(s2 * v0, -1)
    cw = -np.sum(n * v0, -1)
    out = np.concatenate(
        [s1, c1[:, None], s2, c2[:, None], n, cw[:, None]], axis=1)
    return out.astype(np.float32)


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


def build_area_lights(entries) -> dict:
    """Light entries -> the light table as numpy arrays."""
    L = len(entries)
    kind = np.zeros(L, np.int32)
    mat = np.zeros(L, np.int32)
    area = np.zeros(L, np.float32)
    p0 = np.zeros((L, 3), np.float32)
    axis = np.zeros((L, 3), np.float32)
    radius = np.zeros(L, np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    tri_lo = np.zeros(L, np.int32)
    tri_hi = np.zeros(L, np.int32)
    cdf_base = np.zeros(L, np.float32)
    em, cdf_parts = [], []
    mesh_ord = 0
    for i, e in enumerate(entries):
        kind[i] = e["kind"]
        mat[i] = e["mat"]
        if e["kind"] == KIND_SPHERE:
            p0[i] = e["p0"]
            radius[i] = e["radius"]
            area[i] = 4.0 * np.pi * e["radius"] ** 2
        elif e["kind"] == KIND_CYLINDER:
            p0[i] = e["p0"]
            axis[i] = e["axis"]
            radius[i] = e["radius"]
            rot[i] = e["rot"]
            h = np.linalg.norm(e["axis"])
            area[i] = (2 * np.pi * e["radius"] * h
                       + 2 * np.pi * e["radius"] ** 2)
        else:
            tris = np.asarray(e["tris"], np.float32)
            a = 0.5 * np.linalg.norm(
                np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]),
                axis=-1)
            area[i] = a.sum()
            tri_lo[i] = sum(x.shape[0] for x in em)
            tri_hi[i] = tri_lo[i] + tris.shape[0]
            em.append(tris)
            cdf_parts.append(mesh_ord + np.cumsum(a) / max(a.sum(), 1e-12))
            cdf_base[i] = mesh_ord
            mesh_ord += 1
    if em:
        em_all = np.concatenate(em, 0)
        cdf_all = np.concatenate(cdf_parts).astype(np.float32)
        ev = [np.ascontiguousarray(em_all[:, k]) for k in range(3)]
    else:
        ev = [np.zeros((0, 3), np.float32)] * 3
        cdf_all = np.zeros((0,), np.float32)
    return dict(kind=kind, mat=mat, area=area, p0=p0, axis=axis,
                radius=radius, rot=rot, tri_lo=tri_lo, tri_hi=tri_hi,
                cdf_base=cdf_base, em_v0=ev[0], em_v1=ev[1], em_v2=ev[2],
                em_cdf=cdf_all)


def make_camera(p, height_ratio, quaternion_xyzw, width, height) -> dict:
    """Camera axes from a position, height ratio and xyzw quaternion."""
    p = np.asarray(p, np.float32)
    q = np.asarray(quaternion_xyzw, np.float64)
    qv, w = q[:3], q[3]

    def rot(v):
        t = 2.0 * np.cross(qv, v)
        return (v + w * t + np.cross(qv, t)).astype(np.float32)

    aspect = width / height
    return dict(
        p=p.copy(),
        x_axis=np.asarray(height_ratio * aspect * rot([1.0, 0.0, 0.0]),
                          np.float32),
        y_axis=np.asarray(height_ratio * rot([0.0, 1.0, 0.0]), np.float32),
        z_axis=rot([0.0, 0.0, 1.0]))


# triangles per box of the culled sweep (reference/segment._tri_sweep)
CHUNK = 128


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from centroid positions (frozen copy of
    ``ops/bvh.morton_codes``)."""
    lo = centroids.min(0)
    hi = centroids.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))


def slot_order(tv) -> np.ndarray:
    """The triangles (T, 3, 3) in the order of the kernel's slots: by the
    Morton code of their centroids, stable (``ops/bvh.build_tri_bvh``).
    The kernel breaks a tie between two triangles at one truncated
    distance by this order, and so does the reference."""
    centroids = (tv[:, 0] + tv[:, 1] + tv[:, 2]) / 3.0
    return np.argsort(morton_codes(centroids), kind="stable").astype(
        np.int64)


def chunk_boxes(tv):
    """(C, 3) min and max corners of each run of CHUNK triangles of tv
    (T, 3, 3), widened by a millionth of the scene's extent plus 1e-6, so
    that rounding in the slab test culls no triangle a ray can hit."""
    T = tv.shape[0]
    C = -(-T // CHUNK)
    pad = C * CHUNK - T
    v = np.concatenate([tv, np.repeat(tv[:1], pad, 0)]) if pad else tv
    v = v.reshape(C, CHUNK * 3, 3)
    lo, hi = v.min(1), v.max(1)
    if T:
        slack = 1e-6 * float(np.abs(tv).max()) + 1e-6
        lo, hi = lo - slack, hi + slack
    return lo.astype(np.float32), hi.astype(np.float32)


class SceneArrays:
    """Accumulates a recipe's calls (the port's builder method names)."""

    def __init__(self):
        self.mats = {"diffuse": [[0.0] * 3], "specular": [[0.0] * 3],
                     "spec_exp": [1.0], "transmission": [[0.0] * 3],
                     "ior": [1.0], "emit": [[0.0] * 3], "is_light": [False]}
        self.spheres, self.boxes, self.cylinders = [], [], []
        self.tri_v, self.tri_m, self.lights = [], [], []
        self.camera = None

    def _push_mat(self, diffuse, specular, spec_exp, transmission, ior,
                  emit, is_light):
        m = self.mats
        for k, x in (("diffuse", list(diffuse)), ("specular", list(specular)),
                     ("spec_exp", float(spec_exp)),
                     ("transmission", list(transmission)),
                     ("ior", float(ior)), ("emit", list(emit)),
                     ("is_light", is_light)):
            m[k].append(x)

    def add_material(self, diffuse=(0, 0, 0), specular=(0, 0, 0),
                     spec_exp=1.0, transmission=(0, 0, 0), ior=1.0):
        self._push_mat(diffuse, specular, spec_exp, transmission, ior,
                       (0.0, 0.0, 0.0), False)

    def add_light_material(self, emit):
        self._push_mat((0, 0, 0), (0, 0, 0), 1.0, (0, 0, 0), 1.0, emit, True)

    @property
    def cur(self) -> int:
        return len(self.mats["ior"]) - 1

    def _light(self) -> bool:
        return bool(self.mats["is_light"][self.cur])

    def add_sphere(self, center, radius):
        c = np.asarray(center, np.float32)
        self.spheres.append((c, float(radius), self.cur))
        if self._light():
            self.lights.append(dict(kind=KIND_SPHERE, mat=self.cur, p0=c,
                                    radius=float(radius)))

    def add_box_minmax(self, bmin, bmax):
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        self.boxes.append((bmin, bmax, self.cur))
        if self._light():
            self.lights.append(dict(kind=KIND_MESH, mat=self.cur,
                                    tris=_box_tris(bmin, bmax)))

    def add_cylinder(self, base, axis, radius):
        base = np.asarray(base, np.float32)
        axis = np.asarray(axis, np.float32)
        self.cylinders.append((base, axis, float(radius), self.cur))
        if self._light():
            self.lights.append(dict(kind=KIND_CYLINDER, mat=self.cur,
                                    p0=base, axis=axis, radius=float(radius),
                                    rot=rotation_matrix_to_z(axis)))

    def add_triangles(self, vertices, indices):
        v = np.asarray(vertices, np.float32)[np.asarray(indices, np.int64)]
        self.tri_v.append(v)
        self.tri_m.append(np.full((v.shape[0],), self.cur, np.int32))
        if self._light():
            self.lights.append(dict(kind=KIND_MESH, mat=self.cur, tris=v))

    def set_camera(self, p, height_ratio, quat_xyzw):
        self.camera = (p, height_ratio, quat_xyzw)

    def build(self, width, height, device) -> "RefScene":
        return RefScene.of(self, width, height, device)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


@dataclasses.dataclass
class RefScene:
    """What the reference tracer reads, as float32/int tensors."""

    consts: torch.Tensor      # (46, C) primitive and material rows
    ns: int
    nb: int
    nc: int
    nm: int
    nl: int
    tri: torch.Tensor         # (T, 12) coefficient rows, recipe order
    tri_mat: torch.Tensor     # (T,) int32
    tri_order: torch.Tensor   # (T,) triangles in the kernel's slot order
    tri_rank: torch.Tensor    # (T,) each triangle's place in that order
    chunk_lo: torch.Tensor    # (C, 3) boxes of runs of CHUNK triangles,
    chunk_hi: torch.Tensor    # (C, 3) widened a little, recipe order
    v0: torch.Tensor          # (T, 3) the triangles' vertices
    v1: torch.Tensor
    v2: torch.Tensor
    mats: dict                # material table: diffuse, specular,
    #                           transmission, emit (M, 3), ior (M,)
    lights: dict              # the light table as tensors
    camera: dict              # p, x_axis, y_axis, z_axis tensors

    @property
    def emit(self) -> torch.Tensor:
        return self.mats["emit"]

    @property
    def tri_base(self) -> int:
        return self.ns + self.nb + self.nc

    @classmethod
    def of(cls, a: SceneArrays, width, height, device) -> "RefScene":
        dev = torch.device(device)
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        m = a.mats
        diffuse, specular = f32(m["diffuse"]), f32(m["specular"])
        transmission, ior = f32(m["transmission"]), f32(m["ior"])
        emit = f32(m["emit"])
        is_light = f32(np.asarray(m["is_light"], np.float32))
        spec_exp = f32(m["spec_exp"])
        nm = ior.shape[0]
        mat_to_light = np.full((nm,), -1, np.int32)
        for li, e in enumerate(a.lights):
            mat_to_light[e["mat"]] = li
        C = max(LANE, len(a.spheres), len(a.boxes), len(a.cylinders), nm,
                len(a.lights))

        def row(x, fill=0.0):
            x = torch.as_tensor(np.asarray(x, np.float32),
                                device=dev).reshape(-1)
            return torch.cat([x, torch.full((C - x.shape[0],), fill,
                                            dtype=torch.float32, device=dev)])

        sph = a.spheres
        rows = [row([s[0][k] for s in sph], PARK) for k in range(3)]
        rows += [row([s[1] for s in sph]), row([s[2] for s in sph])]
        box = a.boxes
        rows += [row([b[0][k] for b in box], INF) for k in range(3)]
        rows += [row([b[1][k] for b in box], -INF) for k in range(3)]
        rows += [row([b[2] for b in box])]
        cyl = a.cylinders
        rots = [rotation_matrix_to_z(c[1]) for c in cyl]
        rows += [row([c[0][k] for c in cyl], PARK) for k in range(3)]
        rows += [row([c[2] for c in cyl])]
        h = (_norm(f32([c[1] for c in cyl])) if cyl
             else torch.zeros((0,), device=dev))
        rows += [row(h.cpu().numpy())]
        for i in range(3):
            for j in range(3):
                rows += [row([r[i, j] for r in rots], 1.0 if i == j else 0.0)]
        rows += [row([c[3] for c in cyl])]
        ld, ls, lt = _norm(diffuse), _norm(specular), _norm(transmission)
        s = torch.clamp(ld + ls + lt, min=1e-12)
        # the roughness rows: RenderConfig's default_roughness or the
        # material's exponent, resolved by trace() from the config
        rows += [row(diffuse[:, k].cpu().numpy()) for k in range(3)]
        rows += [row(specular[:, k].cpu().numpy()) for k in range(3)]
        rows += [row(transmission[:, k].cpu().numpy()) for k in range(3)]
        rows += [row(torch.clamp(ior, min=1.0).cpu().numpy(), 1.0)]
        rows += [row(emit[:, k].cpu().numpy()) for k in range(3)]
        rows += [row(is_light.cpu().numpy()), row(mat_to_light, -1.0),
                 row(spec_exp.cpu().numpy(), 1.0),
                 row((ld / s).cpu().numpy()), row((ls / s).cpu().numpy())]
        lt_tab = build_area_lights(a.lights)
        nl = len(a.lights)
        rows += [row(1.0 / (np.maximum(lt_tab["area"], 1e-12) * nl)
                     if nl else [])]
        consts = torch.stack(rows).contiguous()

        if a.tri_v:
            tv = np.concatenate(a.tri_v, 0)
            tm = np.concatenate(a.tri_m, 0)
        else:
            tv = np.zeros((0, 3, 3), np.float32)
            tm = np.zeros((0,), np.int32)
        tri = f32(triangle_coefficients(tv[:, 0], tv[:, 1], tv[:, 2])
                  if tv.shape[0] else np.zeros((0, 12), np.float32))
        lo, hi = chunk_boxes(tv)
        order = (slot_order(tv) if tv.shape[0]
                 else np.zeros((0,), np.int64))
        rank = np.empty_like(order)
        rank[order] = np.arange(order.shape[0])
        lights = {k: torch.as_tensor(v, device=dev)
                  for k, v in lt_tab.items()}
        p, hr, q = a.camera
        camera = {k: torch.as_tensor(v, device=dev) for k, v in
                  make_camera(p, hr, q, width, height).items()}
        return cls(consts=consts, ns=len(sph), nb=len(box), nc=len(cyl),
                   nm=nm, nl=nl, tri=tri,
                   tri_mat=torch.as_tensor(tm, device=dev),
                   tri_order=torch.as_tensor(order, device=dev),
                   tri_rank=torch.as_tensor(rank, device=dev),
                   chunk_lo=f32(lo), chunk_hi=f32(hi),
                   v0=f32(tv[:, 0]), v1=f32(tv[:, 1]), v2=f32(tv[:, 2]),
                   mats={"diffuse": diffuse, "specular": specular,
                         "transmission": transmission, "emit": emit,
                         "ior": ior},
                   lights=lights, camera=camera)
