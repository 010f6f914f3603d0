"""Hits recomputed from known winners, attached to the ray and the scene.

Frozen copies of ``sphere_hit_one``, ``box_hit_one``, ``cylinder_hit_one``
and ``triangle_hit_one`` of ``offline_raytracer_tpu_torch/ops/intersect.py``
at commit 7999567 (last changed in c7b6d06), and the blend of
``hit_from_params``: the search picks integer winners with nothing
attached, and gradients flow through these recomputes, as in the port's
path replay (``replay.py``). ``winner_hit`` reads the reference's own
tables and the id encoding of ``reference/segment.py``.
"""

from __future__ import annotations

import torch

from portbench.reference.scene import BOX, CYL, SPH

INF = float("inf")


def _sum3(x):
    return torch.sum(x, dim=-1)


def _norm(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def sphere_hit_one(center, radius, ro, rd, t_min):
    rel = ro - center
    b = _sum3(rd * rel)
    c = _sum3(rel * rel) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    tn, tp = -b - sq, -b + sq
    inner = tn < t_min
    t = torch.where(inner, tp, tn)
    return t, rel + t[..., None] * rd


def box_hit_one(bmin, bmax, ro, rd, t_min):
    inv = 1.0 / rd
    t0 = (bmin - ro) * inv
    t1 = (bmax - ro) * inv
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t_entry = tn.amax(-1)
    t_exit = tf.amin(-1)
    inner = t_entry < t_min
    t = torch.where(inner, t_exit, t_entry)
    axis = torch.where(inner, torch.argmin(tf, -1), torch.argmax(tn, -1))
    n_axis = torch.stack([axis == 0, axis == 1, axis == 2], -1).to(ro.dtype)
    sgn = torch.sign(torch.gather(rd, -1, axis[..., None]))[..., 0]
    return t, n_axis * torch.where(inner, sgn, -sgn)[..., None]


def cylinder_hit_one(base, axis, radius, rot, ro, rd, t_min):
    o = torch.einsum("rij,rj->ri", rot, ro - base)
    d = torch.einsum("rij,rj->ri", rot, rd)
    height = _norm(axis)
    dz = torch.where(torch.abs(d[..., 2]) > 1e-12, d[..., 2], 1e-12)
    t_bot = -o[..., 2] / dz
    t_top = (height - o[..., 2]) / dz
    t_slab_min = torch.minimum(t_bot, t_top)
    t_slab_max = torch.maximum(t_bot, t_top)
    a = _sum3(d[..., :2] ** 2)
    b = _sum3(d[..., :2] * o[..., :2])
    c = _sum3(o[..., :2] ** 2) - radius ** 2
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    a_ok = a > 1e-12
    safe_a = torch.where(a_ok, a, 1.0)
    t_cyl_min = torch.where(a_ok, (-b - sq) / safe_a, -INF)
    t_cyl_max = torch.where(a_ok, (-b + sq) / safe_a, INF)
    t_entry = torch.maximum(t_slab_min, t_cyl_min)
    t_exit = torch.minimum(t_slab_max, t_cyl_max)
    inner = t_entry < t_min
    t = torch.where(inner, t_exit, t_entry)
    cap_win = torch.where(inner, t_slab_max < t_cyl_max,
                          t_slab_min > t_cyl_min)
    p_local = o + t[..., None] * d
    zero = torch.zeros_like(t)
    n_side = torch.stack([p_local[..., 0], p_local[..., 1], zero], -1)
    n_cap_z = torch.where(p_local[..., 2] > 0.5 * height, 1.0, -1.0)
    n_cap = torch.stack([zero, zero, n_cap_z.to(t.dtype)], -1)
    n_local = torch.where(cap_win[..., None], n_cap, n_side)
    return t, torch.einsum("rji,rj->ri", rot, n_local)


def triangle_hit_one(v0, v1, v2, ro, rd, t_min):
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(rd, e2)
    det = _sum3(pvec * e1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    tvec = ro - v0
    qvec = _cross(tvec, e1)
    t = _sum3(qvec * e2) * inv_det
    return t, _cross(e1, e2)


def winner_hit(sc, ids, ro, rd, t_min):
    """(t (R,), unit normal (R, 3), material (R,) int32) of each ray's
    recorded winner ``ids`` (-1 = miss: t = inf, material 0), recomputed
    from ``sc``'s tables; the triangles' vertices ``sc.v0``/``v1``/``v2``
    may carry gradients."""
    c = sc.consts
    ns, nb, nc = sc.ns, sc.nb, sc.nc
    valid = ids >= 0
    i = torch.clamp(ids, min=0).long()
    R = ro.shape[0]
    t = torch.full((R,), INF, dtype=torch.float32, device=ro.device)
    normal = torch.zeros((R, 3), dtype=torch.float32, device=ro.device)

    mat = torch.zeros((R,), dtype=torch.int32, device=ro.device)

    def blend(sel, t_i, n_i, m_i):
        nonlocal t, normal, mat
        t = torch.where(sel, t_i, t)
        normal = torch.where(sel[..., None], n_i, normal)
        mat = torch.where(sel, m_i.to(torch.int32), mat)

    col = lambda rows, j: c[rows][:, j].T  # noqa: E731
    if ns:
        j = torch.clamp(i, 0, ns - 1)
        blend(valid & (i < ns), *sphere_hit_one(
            col(slice(SPH, SPH + 3), j), c[SPH + 3][j], ro, rd, t_min),
            c[SPH + 4][j])
    if nb:
        j = torch.clamp(i - ns, 0, nb - 1)
        blend(valid & (i >= ns) & (i < ns + nb), *box_hit_one(
            col(slice(BOX, BOX + 3), j), col(slice(BOX + 3, BOX + 6), j),
            ro, rd, t_min), c[BOX + 6][j])
    if nc:
        j = torch.clamp(i - ns - nb, 0, nc - 1)
        rot = c[CYL + 5:CYL + 14][:, j].T.reshape(-1, 3, 3)
        base = col(slice(CYL, CYL + 3), j)
        height = c[CYL + 4][j]
        # the cylinder's axis enters only through its length (the height)
        axis = torch.stack([torch.zeros_like(height)] * 2 + [height], -1)
        blend(valid & (i >= ns + nb) & (i < ns + nb + nc), *cylinder_hit_one(
            base, axis, c[CYL + 3][j], rot, ro, rd, t_min), c[CYL + 14][j])
    if sc.v0.shape[0]:
        j = torch.clamp(i - sc.tri_base, 0, sc.v0.shape[0] - 1)
        blend(valid & (i >= sc.tri_base), *triangle_hit_one(
            sc.v0[j], sc.v1[j], sc.v2[j], ro, rd, t_min), sc.tri_mat[j])
    normal = normal / torch.clamp(_norm(normal, keepdim=True), min=1e-12)
    return t, normal, mat
