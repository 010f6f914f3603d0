"""The reference's bounce: plane-by-plane shading of one bounce.

Frozen copy of the plain segment of ``offline_raytracer_tpu_torch/ops/
mega.py`` (``mega_segment_plain`` and its plane helpers) at commit 7999567
(last changed in c7b6d06), cut loose from the program's tables: it reads
a ``reference.scene.RefScene`` built from the recipe's raw arrays, and its
triangle test is a dense sweep over every triangle in recipe order (the
program walks a BVH and orders its triangle slots by Morton code).

The semantics it holds the program to (``ops/mega.py``'s docstring): the
analytic order is spheres, boxes, cylinders with strict ``<``; the
triangle winner is the least (hit t with its low 7 mantissa bits cleared,
slot) among triangles hit nearer than the analytic hit, the slots in the
Morton order of the triangles' centroids (``scene.slot_order``), and that
truncated t is what shading uses; emission with MIS, next-event
estimation with an any-hit shadow test, Russian roulette, the 3-lobe BSDF.
``bounce`` takes a ``q`` that rounds the carried state, the hook of the
control (``reference/paths.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hits import winner_hit
from portbench.reference.scene import (
    BOX, CYL, INF, LANE, LGT, MAT, PARK, SPH)

PI = 3.14159265358979
INF_ENC = int(np.array(INF, np.float32).view(np.int32)) & ~127


def _sign(x):
    """jnp.sign semantics: sign(0) = 0, sign(NaN) = NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vwhere(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def vnormalize(a, eps=1e-8):
    inv = torch.rsqrt(torch.clamp(vdot(a, a), min=eps * eps))
    return vscale(inv, a)


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _schlick(ks, cos_d):
    m = torch.clamp(1.0 - torch.abs(cos_d), 0.0, 1.0)
    m2 = m * m
    p5 = m2 * m2 * m
    return tuple(k + (1.0 - k) * p5 for k in ks)


def _ggx_d(n_dot_h, rough):
    a2 = rough * rough
    c = torch.clamp(n_dot_h, 1e-6, 1.0)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    s = a2 + tan2
    denom = PI * c2 * c2 * (s * s)
    d = a2 / torch.clamp(denom, min=1e-20)
    return torch.where(n_dot_h > 0.0, d, 0.0)


def _smith_g1(w, n, m, rough):
    w_dot_n = vdot(w, n)
    w_dot_m = vdot(w, m)
    same_side = (w_dot_n * w_dot_m) > 0.0
    c2 = torch.clamp(w_dot_n * w_dot_n, 1e-9, 1.0)
    tan2 = (1.0 - c2) / c2
    g = 2.0 / (1.0 + torch.sqrt(1.0 + rough * rough * tan2))
    return torch.where(same_side, g, 0.0)


def _etas(n_dot_wo, ior):
    outside = n_dot_wo >= 0.0
    return (torch.where(outside, 1.0, ior), torch.where(outside, ior, 1.0))


def eval_bsdf_pl(n, wi, wo, mp, distance):
    """f(wi, wo) |wi.n| as an rgb plane triple."""
    n_dot_wi = vdot(wi, n)
    n_dot_wo = vdot(wo, n)
    same_side = (n_dot_wi * n_dot_wo) > 0.0
    ed = tuple(torch.where(same_side, k / PI, 0.0) for k in mp["kd"])

    sgn_wi = _sign(n_dot_wi)
    h = vscale(sgn_wi, vnormalize(vadd(wi, wo)))
    wi_dot_h = vdot(wi, h)
    f_spec = _schlick(mp["ks"], wi_dot_h)
    d_spec = _ggx_d(vdot(n, h), mp["rough"])
    g_spec = (_smith_g1(wi, n, h, mp["rough"])
              * _smith_g1(wo, n, h, mp["rough"]))
    denom_s = 4.0 * torch.clamp(torch.abs(n_dot_wi) * torch.abs(n_dot_wo),
                                min=1e-6)
    spec_scale = d_spec * g_spec / denom_s
    ks2 = vdot(mp["ks"], mp["ks"])
    h_faces_wi = wi_dot_h * sgn_wi > 0.0
    has_spec = (ks2 > 0.0) & h_faces_wi & same_side
    es = tuple(torch.where(has_spec, f * spec_scale, 0.0) for f in f_spec)

    eta_wo, eta_wi = _etas(n_dot_wo, mp["ior"])
    ht = vneg(vadd(vscale(eta_wo, wo), vscale(eta_wi, wi)))
    m = vnormalize(ht)
    m = vscale(_sign(vdot(m, n)), m)
    wo_dot_m = vdot(wo, m)
    wi_dot_m = vdot(wi, m)
    eta = eta_wo / eta_wi

    inside = n_dot_wo < 0.0
    att = tuple(
        torch.where(inside, torch.exp(distance * torch.log(
            torch.clamp(k, 1e-6, 1.0))), 1.0)
        for k in mp["kt"])

    d_t = _ggx_d(vdot(n, m), mp["rough"])
    g_t = (_smith_g1(wi, n, m, mp["rough"])
           * _smith_g1(wo, n, m, mp["rough"]))
    f_t = _schlick(mp["ks"], wi_dot_m)
    jd = eta_wo * wo_dot_m + eta_wi * wi_dot_m
    jac_denom = jd * jd
    denom_t = torch.clamp(
        torch.abs(n_dot_wi) * torch.abs(n_dot_wo)
        * torch.clamp(jac_denom, min=1e-9), min=1e-9)
    num_t = (d_t * g_t * torch.abs(wi_dot_m) * torch.abs(wo_dot_m)
             * eta_wi * eta_wi)
    t_scale = num_t / denom_t
    et_refract = tuple(
        torch.where(~same_side, (1.0 - f) * t_scale, 0.0) for f in f_t)
    wo_dot_h = vdot(wo, h)
    radicand_h = 1.0 - eta * eta * (1.0 - wo_dot_h * wo_dot_h)
    es_tir_on = same_side & (radicand_h < 0.0) & h_faces_wi
    es_tir = tuple(torch.where(es_tir_on, f * spec_scale, 0.0)
                   for f in f_spec)
    kt2 = vdot(mp["kt"], mp["kt"])
    has_trans = kt2 > 0.0
    et = tuple(
        torch.where(has_trans, a * torch.where(same_side, ei, er), 0.0)
        for a, ei, er in zip(att, es_tir, et_refract))

    aw = torch.abs(n_dot_wi)
    return tuple(aw * (d + s_ + t_) for d, s_, t_ in zip(ed, es, et))


def pdf_bsdf_pl(n, wi, wo, mp):
    """Mixture pdf of sample_bsdf_pl."""
    pd_c, ps_c = mp["pd_c"], mp["ps_c"]
    pt_c = torch.clamp(1.0 - pd_c - ps_c, min=0.0)
    n_dot_wi = vdot(wi, n)
    n_dot_wo = vdot(wo, n)

    pd = torch.clamp(n_dot_wi * _sign(n_dot_wo), min=0.0) / PI
    same_side = (n_dot_wi * n_dot_wo) > 0.0

    h = vscale(_sign(n_dot_wi), vnormalize(vadd(wi, wo)))
    wi_dot_h = vdot(wi, h)
    n_dot_h = vdot(n, h)
    d_spec = _ggx_d(n_dot_h, mp["rough"])
    ps = d_spec * torch.abs(n_dot_h) / torch.clamp(
        4.0 * torch.abs(wi_dot_h), min=1e-9)
    ps = torch.where(same_side, ps, 0.0)

    eta_wo, eta_wi = _etas(n_dot_wo, mp["ior"])
    m = vnormalize(vneg(vadd(vscale(eta_wo, wo), vscale(eta_wi, wi))))
    m = vscale(_sign(vdot(m, n)), m)
    wo_dot_m = vdot(wo, m)
    wi_dot_m = vdot(wi, m)
    eta = eta_wo / eta_wi
    d_t = _ggx_d(vdot(n, m), mp["rough"])
    jd = eta_wo * wo_dot_m + eta_wi * wi_dot_m
    jac_denom = torch.clamp(jd * jd, min=1e-9)
    pt_refract = (d_t * torch.abs(vdot(n, m)) * eta_wi * eta_wi
                  * torch.abs(wi_dot_m) / jac_denom)
    pt_refract = torch.where(same_side, 0.0, pt_refract)
    wo_dot_h = vdot(wo, h)
    radicand_h = 1.0 - eta * eta * (1.0 - wo_dot_h * wo_dot_h)
    pt = torch.where(same_side, torch.where(radicand_h < 0.0, ps, 0.0),
                     pt_refract)
    return pd_c * pd + ps_c * ps + pt_c * pt


def _frame_to_world_pl(lx, ly, lz, n):
    nx, ny, nz = n
    near_pole = torch.abs(nz) > 0.999
    inv = torch.rsqrt(torch.clamp(nx * nx + ny * ny, min=1e-16))
    zero = torch.zeros_like(nz)
    b0 = vwhere(near_pole, (torch.ones_like(nz), zero, zero),
                (-ny * inv, nx * inv, zero))
    t = vnormalize(vcross(b0, n))
    b = vcross(n, t)
    return vadd(vadd(vscale(lx, t), vscale(ly, b)), vscale(lz, n))


def sample_bsdf_pl(e0, e1, choice, n, wo, mp):
    """(wi triple, is_transmission)."""
    pd_c, ps_c = mp["pd_c"], mp["ps_c"]
    phi = 2.0 * PI * e1
    cphi, sphi = torch.cos(phi), torch.sin(phi)

    n_dot_wo = vdot(wo, n)
    n_face = vscale(_sign(n_dot_wo), n)

    cos_d = torch.sqrt(e0)
    sin_d = torch.sqrt(torch.clamp(1.0 - e0, 0.0, 1.0))
    wi_diffuse = _frame_to_world_pl(sin_d * cphi, sin_d * sphi, cos_d, n_face)

    a2e = mp["rough"] * mp["rough"] * e0 / torch.clamp(1.0 - e0, min=1e-9)
    cos_m = torch.rsqrt(1.0 + a2e)
    sin_m = torch.sqrt(torch.clamp(1.0 - cos_m * cos_m, 0.0, 1.0))
    m = _frame_to_world_pl(sin_m * cphi, sin_m * sphi, cos_m, n_face)

    wo_dot_m = vdot(wo, m)
    wi_spec = vsub(vscale(2.0 * torch.abs(wo_dot_m), m), wo)

    eta_wo, eta_wi = _etas(n_dot_wo, mp["ior"])
    eta = eta_wo / eta_wi
    radicand = 1.0 - eta * eta * (1.0 - wo_dot_m * wo_dot_m)
    tir = radicand < 0.0
    sq = torch.sqrt(torch.clamp(radicand, 0.0, 1.0))
    wi_refract = vsub(vscale(eta * wo_dot_m - sq, m), vscale(eta, wo))
    wi_trans = vwhere(tir, wi_spec, wi_refract)

    pick_d = choice < pd_c
    pick_s = (~pick_d) & (choice < pd_c + ps_c)
    wi = vwhere(pick_d, wi_diffuse, vwhere(pick_s, wi_spec, wi_trans))
    is_trans = (~pick_d) & (~pick_s) & (~tir)
    return vnormalize(wi), is_trans


def _analytic_closest(c, sc, o, d, t_min):
    """Closest analytic hit: (t, normal triple, mat, id) planes."""
    R = o[0].shape[0]
    dev = o[0].device
    bt = torch.full((R,), INF, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(bt)
    bn = (zero, zero, zero + 1.0)
    bm = torch.zeros((R,), dtype=torch.int32, device=dev)
    bi = torch.full((R,), -1, dtype=torch.int32, device=dev)

    def take(ok, t, n, mt, idx):
        nonlocal bt, bn, bm, bi
        bt = torch.where(ok, t, bt)
        bn = vwhere(ok, n, bn)
        bm = torch.where(ok, mt, bm)
        bi = torch.where(ok, torch.full_like(bi, idx), bi)

    S, B, Y = SPH, BOX, CYL
    for j in range(sc.ns):
        cx, cy, cz, r = c[S, j], c[S + 1, j], c[S + 2, j], c[S + 3, j]
        mt = c[S + 4, j].to(torch.int32)
        rel = (o[0] - cx, o[1] - cy, o[2] - cz)
        b = vdot(d, rel)
        cc = vdot(rel, rel) - r * r
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn, tp = -b - sq, -b + sq
        t = torch.where(tn >= t_min, tn, tp)
        ok = (disc > 0.0) & (t >= t_min) & (t < bt)
        take(ok, t, vadd(rel, vscale(t, d)), mt, j)
    for j in range(sc.nb):
        x0, y0, z0 = c[B, j], c[B + 1, j], c[B + 2, j]
        x1, y1, z1 = c[B + 3, j], c[B + 4, j], c[B + 5, j]
        mt = c[B + 6, j].to(torch.int32)
        ivx, ivy, ivz = 1.0 / d[0], 1.0 / d[1], 1.0 / d[2]
        ax0, bx0 = (x0 - o[0]) * ivx, (x1 - o[0]) * ivx
        ay0, by0 = (y0 - o[1]) * ivy, (y1 - o[1]) * ivy
        az0, bz0 = (z0 - o[2]) * ivz, (z1 - o[2]) * ivz
        tnx, tfx = torch.minimum(ax0, bx0), torch.maximum(ax0, bx0)
        tny, tfy = torch.minimum(ay0, by0), torch.maximum(ay0, by0)
        tnz, tfz = torch.minimum(az0, bz0), torch.maximum(az0, bz0)
        t_en = torch.maximum(torch.maximum(tnx, tny), tnz)
        t_ex = torch.minimum(torch.minimum(tfx, tfy), tfz)
        inner = t_en < t_min
        t = torch.where(inner, t_ex, t_en)
        ok = ((t_ex >= torch.clamp(t_en, min=t_min)) & (t >= t_min)
              & (t < bt))
        w0_ex = (tfx <= tfy) & (tfx <= tfz)
        w0_en = (tnx >= tny) & (tnx >= tnz)
        w0 = (inner & w0_ex) | (~inner & w0_en)
        w1 = (~w0) & ((inner & (tfy <= tfz)) | (~inner & (tny >= tnz)))
        w2 = (~w0) & (~w1)
        flip = torch.where(inner, 1.0, -1.0)
        n = (torch.where(w0, flip * _sign(d[0]), 0.0),
             torch.where(w1, flip * _sign(d[1]), 0.0),
             torch.where(w2, flip * _sign(d[2]), 0.0))
        take(ok, t, n, mt, sc.ns + j)
    for j in range(sc.nc):
        bx, by, bz = c[Y, j], c[Y + 1, j], c[Y + 2, j]
        r, h = c[Y + 3, j], c[Y + 4, j]
        q = [c[Y + 5 + k, j] for k in range(9)]
        mt = c[Y + 14, j].to(torch.int32)
        rel = (o[0] - bx, o[1] - by, o[2] - bz)
        ox = q[0] * rel[0] + q[1] * rel[1] + q[2] * rel[2]
        oy = q[3] * rel[0] + q[4] * rel[1] + q[5] * rel[2]
        oz = q[6] * rel[0] + q[7] * rel[1] + q[8] * rel[2]
        dx = q[0] * d[0] + q[1] * d[1] + q[2] * d[2]
        dy = q[3] * d[0] + q[4] * d[1] + q[5] * d[2]
        dz = q[6] * d[0] + q[7] * d[1] + q[8] * d[2]
        dz_s = torch.where(torch.abs(dz) > 1e-12, dz, 1e-12)
        t_bot = -oz / dz_s
        t_top = (h - oz) / dz_s
        t_slab_min = torch.minimum(t_bot, t_top)
        t_slab_max = torch.maximum(t_bot, t_top)
        a = dx * dx + dy * dy
        b = dx * ox + dy * oy
        cc = ox * ox + oy * oy - r * r
        disc = b * b - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        a_ok = a > 1e-12
        safe_a = torch.where(a_ok, a, 1.0)
        t_cyl_min = torch.where(a_ok, (-b - sq) / safe_a, -INF)
        t_cyl_max = torch.where(a_ok, (-b + sq) / safe_a, INF)
        t_en = torch.maximum(t_slab_min, t_cyl_min)
        t_ex = torch.minimum(t_slab_max, t_cyl_max)
        inner = t_en < t_min
        t = torch.where(inner, t_ex, t_en)
        ok = ((disc >= 0.0) & (t_ex >= torch.clamp(t_en, min=t_min))
              & (t >= t_min) & (t < bt))
        cap_win = (inner & (t_slab_max < t_cyl_max)) | (
            (~inner) & (t_slab_min > t_cyl_min))
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        cap_z = torch.where(pz > 0.5 * h, 1.0, -1.0)
        nlx = torch.where(cap_win, 0.0, px)
        nly = torch.where(cap_win, 0.0, py)
        nlz = torch.where(cap_win, cap_z, 0.0)
        n = (q[0] * nlx + q[3] * nly + q[6] * nlz,
             q[1] * nlx + q[4] * nly + q[7] * nlz,
             q[2] * nlx + q[5] * nly + q[8] * nlz)
        take(ok, t, n, mt, sc.ns + sc.nb + j)
    return bt, bn, bm, bi


def _tri_sweep(sc, o, d, bound, t_min, any_hit):
    """Every triangle test a ray can pass, culled by the boxes of runs of
    CHUNK triangles: a (ray, run) pair is tested whole when the ray's
    segment [t_min, bound) meets the run's widened box, which no hit
    misses; every triangle of the pair is then tested as the dense sweep
    tests it.

    Closest hit (any_hit False): the least (t bits with the low 7 cleared,
    place in the kernel's slot order) key among hits with t_min <= t <
    bound, as an int64 plane (INT64_MAX = none). Any hit: a bool plane,
    hit with t < bound.
    """
    tri, lo, hi = sc.tri, sc.chunk_lo, sc.chunk_hi
    R = o[0].shape[0]
    T, C = tri.shape[0], lo.shape[0]
    dev = o[0].device
    big = torch.iinfo(torch.int64).max
    best = torch.full((R,), big, dtype=torch.int64, device=dev)
    O = torch.stack(o, -1)
    D = torch.stack(d, -1)
    inv = 1.0 / D
    rows_per = max(1, (1 << 22) // max(C, 1))
    rr, cc = [], []
    for r0 in range(0, R, rows_per):
        r1 = min(R, r0 + rows_per)
        t0 = (lo[None] - O[r0:r1, None]) * inv[r0:r1, None]
        t1 = (hi[None] - O[r0:r1, None]) * inv[r0:r1, None]
        tn = torch.nan_to_num(torch.minimum(t0, t1), nan=-INF).amax(-1)
        tf = torch.nan_to_num(torch.maximum(t0, t1), nan=INF).amin(-1)
        ok = (tf >= tn) & (tf >= t_min) & (tn < bound[r0:r1, None])
        r, c = ok.nonzero(as_tuple=True)
        rr.append(r + r0)
        cc.append(c)
    rr, cc = torch.cat(rr), torch.cat(cc)
    lane = torch.arange(LANE, device=dev)
    pairs = max(1, (1 << 24) // LANE)
    for p0 in range(0, rr.shape[0], pairs):
        ri, ci = rr[p0:p0 + pairs], cc[p0:p0 + pairs]
        slot = ci[:, None] * LANE + lane[None, :]
        real = slot < T
        cf = tri[torch.clamp(slot, max=T - 1)]
        s1x, s1y, s1z, c1, s2x, s2y, s2z, c2, nx, ny, nz, cw = (
            cf[..., k] for k in range(12))
        ox, oy, oz = (O[ri, k][:, None] for k in range(3))
        dx, dy, dz = (D[ri, k][:, None] for k in range(3))
        o_w = ox * nx + oy * ny + oz * nz + cw
        d_w = dx * nx + dy * ny + dz * nz
        o_u = ox * s1x + oy * s1y + oz * s1z + c1
        d_u = dx * s1x + dy * s1y + dz * s1z
        o_v = ox * s2x + oy * s2y + oz * s2z + c2
        d_v = dx * s2x + dy * s2y + dz * s2z
        ok_w = torch.abs(d_w) > 1e-12
        t = -o_w / torch.where(ok_w, d_w, 1.0)
        u = o_u + t * d_u
        v = o_v + t * d_v
        ok = (real & ok_w & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min) & (t < bound[ri][:, None]))
        if any_hit:
            key = torch.where(ok, 0, big)
        else:
            enc = (t.contiguous().view(torch.int32).to(torch.int64)
                   & ~(LANE - 1))
            rank = sc.tri_rank[torch.clamp(slot, max=T - 1)]
            key = torch.where(ok, (enc << 32) | rank, big)
        best.scatter_reduce_(0, ri, key.min(dim=1).values, reduce="amin")
    return best < big if any_hit else best


def _gather_mat(sc, mi, cfg):
    """Per-ray material planes; the table's entries may carry gradients
    (the lobe weights follow the current albedo)."""
    c = sc.consts
    m = mi.long()
    M = sc.mats
    kd, ks, kt = (M[k][m] for k in ("diffuse", "specular", "transmission"))
    ld, ls, lt = (torch.sqrt(torch.sum(x * x, -1)) for x in (kd, ks, kt))
    s = torch.clamp(ld + ls + lt, min=1e-12)
    if cfg.roughness_from_material:
        rough = torch.sqrt(2.0 / (c[MAT + 15][m] + 2.0))
    else:
        rough = torch.full_like(ld, cfg.default_roughness)
    emit = M["emit"][m]
    return {
        "kd": tuple(kd.unbind(-1)), "ks": tuple(ks.unbind(-1)),
        "kt": tuple(kt.unbind(-1)),
        "ior": torch.maximum(M["ior"][m], torch.ones_like(ld)),
        "emit": tuple(emit.unbind(-1)), "isl": c[MAT + 13][m],
        "tol": c[MAT + 14][m], "rough": rough,
        "pd_c": (ld / s).detach(), "ps_c": (ls / s).detach(),
    }


def _closest(sc, o, d, live, t_min):
    """The search: (t, normal triple, mat, id) of the closest hit, the
    triangle's t truncated as the program's kernel has it."""
    c = sc.consts
    bt, bn, bm, bi = _analytic_closest(c, sc, o, d, t_min)
    if sc.tri.shape[0] > 0:
        key = _tri_sweep(sc, o, d, bt, t_min, any_hit=False)
        enc = key >> 32
        slot = sc.tri_order[(key & 0xFFFFFFFF).clamp(
            max=sc.tri.shape[0] - 1)]
        win = (enc < INF_ENC) & live
        t_win = enc.to(torch.int32).view(torch.float32)
        cn = sc.tri[slot]
        bt = torch.where(win, t_win, bt)
        bn = vwhere(win, (cn[:, 8], cn[:, 9], cn[:, 10]), bn)
        bm = torch.where(win, sc.tri_mat[slot], bm)
        bi = torch.where(win, (sc.tri_base + slot).to(torch.int32), bi)
    return bt, bn, bm, bi


def bounce(sc, cfg, b, st, u8, ls10, q, rec=None):
    """One bounce ``b`` of every ray of ``st`` (a dict of planes: o, d, tp
    triples, prev_pdf, alive, rad triple) with its uniforms ``u8`` (8, R)
    and light sample ``ls10`` (10, R) -> (new state, hit id, NEE
    visibility). ``q`` rounds what the bounce carries on.

    With ``rec``, this bounce's (hit ids, NEE visibility) from a first
    pass, the bounce is the port's path replay
    (``integrator.trace_paths(replay=...)``): nothing is searched, the
    recorded winner's hit is recomputed attached (``hits.winner_hit``, the
    exact t) and the shadow test is the recorded bit; sampled directions,
    sampling pdfs and MIS weights are detached, and the hit geometry, the
    BSDF values, the emission and the light terms stay attached."""
    c = sc.consts
    t_min = float(cfg.t_min)
    hit_eps = float(cfg.hit_eps)
    rr_p = float(cfg.russian_roulette)
    do_nee = bool(cfg.enable_nee and sc.nl > 0)
    do_mis = bool(do_nee and cfg.enable_mis)
    o, d, tp = st["o"], st["d"], st["tp"]
    prev_pdf, alive, rad = st["prev_pdf"], st["alive"], st["rad"]
    f0 = torch.zeros_like(prev_pdf)
    park = (f0 + PARK, f0 + PARK, f0 + PARK)
    live = alive

    # ---- closest hit: analytic, then triangles nearer than it
    if rec is not None:
        bi = rec[0]
        t, nv, bm = winner_hit(sc, bi, torch.stack(o, -1),
                               torch.stack(d, -1), t_min)
        n = tuple(nv.unbind(-1))
        valid = bi >= 0
    else:
        bt, bn, bm, bi = _closest(sc, o, d, live, t_min)
        t = bt
        n = vnormalize(bn, 1e-12)
        valid = t < INF
    mp = _gather_mat(sc, torch.where(valid, bm, 0), cfg)

    # ---- emission with MIS
    hit_light = (mp["isl"] > 0.5) & valid
    if do_nee and do_mis:
        tol = mp["tol"]
        has_l = (tol >= 0.0) & (tol < sc.nl)
        inv_l_hit = torch.where(
            has_l, c[LGT][tol.clamp(0, c.shape[1] - 1).long()], 0.0)
        cos_l = vdot(n, vneg(d))
        p_nee = inv_l_hit * t * t / torch.clamp(torch.abs(cos_l), min=1e-6)
        p_nee = torch.where(valid, p_nee, 0.0)
        mis_applies = (tol >= 0.0) & (prev_pdf >= 0.0)
        mis_w = torch.where(
            mis_applies,
            prev_pdf / torch.clamp(prev_pdf + p_nee, min=1e-12), 1.0)
        mis_w = mis_w.detach()
    elif do_nee:
        front = vdot(n, vneg(d)) > 1e-6
        mis_w = torch.where(
            (mp["tol"] >= 0.0) & (prev_pdf >= 0.0) & front, 0.0, 1.0)
    else:
        mis_w = f0 + 1.0
    if cfg.reference_rr_quirk and rr_p < 1.0 and b > cfg.rr_start_bounce:
        mis_w = mis_w * torch.where(prev_pdf >= 0.0, rr_p, 1.0)
    add_emit = alive & hit_light
    rad_n = tuple(rk + torch.where(add_emit, tk * ek * mis_w, 0.0)
                  for rk, tk, ek in zip(rad, tp, mp["emit"]))

    alive_n = alive & valid & ~hit_light

    # ---- shading point
    t_safe = torch.where(valid, t, 1.0)
    x = vadd(o, vscale(t_safe - hit_eps, d))
    x = vwhere(alive_n, x, o)
    wo = vneg(d)
    seg_len = torch.where(valid, t, 0.0)

    # ---- next-event estimation with the any-hit shadow test
    vis_out = f0 + 1.0
    if do_nee:
        lp = (ls10[0], ls10[1], ls10[2])
        ln = (ls10[3], ls10[4], ls10[5])
        lemit = (ls10[6], ls10[7], ls10[8])
        pdf_area = ls10[9]
        to_l = vsub(lp, x)
        dist = torch.sqrt(torch.clamp(vdot(to_l, to_l), min=1e-18))
        wi_l = vscale(1.0 / dist, to_l)
        cos_l2 = vdot(ln, vneg(wi_l))
        p_nee_solid = pdf_area * dist * dist / torch.clamp(
            torch.abs(cos_l2), min=1e-6)
        worth = alive_n & (cos_l2 > 1e-6)
        xs = vwhere(worth, x, park)
        tfb = torch.where(worth, dist * (1.0 - 1e-3), 0.0)
        if rec is not None:
            occ = rec[1] <= 0.5
        else:
            ta, _, _, _ = _analytic_closest(c, sc, xs, wi_l, t_min)
            occ = ta < tfb
            if sc.tri.shape[0] > 0:
                occ = occ | _tri_sweep(sc, xs, wi_l,
                                       torch.where(occ, 0.0, tfb), t_min,
                                       any_hit=True)
        visible = ~occ
        vis_out = visible.to(torch.float32)
        f_l = eval_bsdf_pl(n, wi_l, wo, mp, seg_len)
        if do_mis:
            p_b = pdf_bsdf_pl(n, wi_l, wo, mp)
            w_l = (p_nee_solid / torch.clamp(p_nee_solid + p_b,
                                             min=1e-12)).detach()
        else:
            w_l = f0 + 1.0
        good = (alive_n & visible & (cos_l2 > 1e-6) & (p_nee_solid > 1e-9))
        geom = cos_l2 / torch.clamp(dist * dist, min=1e-12)
        scale = geom * w_l / torch.clamp(pdf_area, min=1e-12)
        rad_n = tuple(rk + torch.where(good, tk * fk * ek * scale, 0.0)
                      for rk, tk, fk, ek in zip(rad_n, tp, f_l, lemit))

    # ---- Russian roulette
    tp_n = tp
    if rr_p < 1.0 and b >= cfg.rr_start_bounce:
        alive_n = alive_n & (u8[4] < rr_p)
        tp_n = tuple(tk / rr_p for tk in tp_n)

    # ---- BSDF continuation
    wi, is_trans = sample_bsdf_pl(u8[5], u8[6], u8[7], n, wo, mp)
    wi = tuple(x.detach() for x in wi)
    pdf = pdf_bsdf_pl(n, wi, wo, mp).detach()
    f = eval_bsdf_pl(n, wi, wo, mp, seg_len)
    ok_pdf = pdf > 1e-8
    upd = alive_n & ok_pdf
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-8)
    tp_n = tuple(torch.where(upd, tk * fk * inv_pdf, tk)
                 for tk, fk in zip(tp_n, f))
    alive_n = alive_n & ok_pdf
    x_next = vwhere(is_trans, vadd(o, vscale(t_safe + hit_eps, d)), x)

    # ---- commit the lanes that were alive at the bounce's start
    qt = lambda v: tuple(q(k) for k in v)  # noqa: E731
    out = {
        "o": qt(vwhere(live, vwhere(alive_n, x_next, park), o)),
        "d": qt(vwhere(live & alive_n, wi, d)),
        "tp": qt(vwhere(live, tp_n, tp)),
        "prev_pdf": q(torch.where(live, torch.where(alive_n, pdf, -1.0),
                                  prev_pdf)),
        "rad": vwhere(live, rad_n, rad),
        "alive": alive_n,
    }
    rec_id = torch.where(live, bi, -1)
    return out, rec_id, torch.where(live, vis_out, 0.0)
