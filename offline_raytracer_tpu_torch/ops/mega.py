"""Fused bounce segments (counterpart of ``offline_raytracer_tpu/ops/mega.py``).

A segment runs bounces ``[b_start, b_start + nf)`` for every ray of a
wavefront: analytic closest hit (spheres, boxes, cylinders), triangle
closest hit over the packed LBVH, emission with MIS, next-event estimation
with an any-hit shadow test, Russian roulette and the 3-lobe BSDF. It
returns the new state, the radiance delta and per-bounce records (hit id in
the MegaMeta encoding, NEE visibility, alive).

Two implementations share one contract:

- ``mega_segment_cuda``: the hand-written Hopper kernel ``csrc/mega.cu``
  (a group of ``group_size`` lanes per ray splitting each leaf's triangle
  test, one stackless BVH walk per group), counted in ``KERNEL_LAUNCHES``;
- ``mega_segment_plain``: plain PyTorch, a plane-by-plane transcription of
  the JAX kernel with a dense, chunked triangle sweep in place of the walk.

``mega_segment`` takes the kernel for CUDA tensors and the plain version
for CPU tensors (``ops/_kernels.takes_kernel``); there is no fallback from
one to the other.
``render_paths_mega`` is the host loop around the segments: padding and
parking, the segment plan, the per-bounce uniform and light-sample planes
(``ops/light_sample.py``), the coherence sort between early bounces with
its incremental inverse permutation, and the alive counts.

Rules both implementations share (and the JAX kernel follows up to ties):
the analytic order is spheres, boxes, cylinders with strict ``<``; the
triangle winner is the least (hit t with its low 7 mantissa bits cleared,
slot) among triangles hit nearer than the analytic hit, and its truncated t
is what shading uses; a ray dead at a bounce's start keeps its state and
writes the records (-1, 0, 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.ops import _kernels, light_sample
from offline_raytracer_tpu_torch.ops.bvh import SUB
from offline_raytracer_tpu_torch.ops.traverse import leaf_major, tri_tables
from offline_raytracer_tpu_torch.utils import profiling, rng

INF = 3.4e38
LANE = 128          # columns of the consts table (entries per scene table)
PARK = 1e8          # parked-ray origin
PI = 3.14159265358979
BLOCK = 256         # rays are padded to a multiple of this
GROUPS = (1, 2, 4, 8, 16, 32)   # lanes per ray the kernel is built for
GROUP_LANES = 1 << 20   # lanes group_size aims a segment's live rays at
GROUP_MAX = 8           # most lanes group_size gives a ray (see group_size)
INF_ENC = int(np.array(INF, np.float32).view(np.int32)) & ~127

# launches of the CUDA kernel; chip runs read it to prove the main path
# went through the kernel
KERNEL_LAUNCHES = 0

# consts row layout (pack_consts; offsets in MegaMeta)
N_SPH_ROWS = 5    # cx cy cz r mat
N_BOX_ROWS = 7    # x0 y0 z0 x1 y1 z1 mat
N_CYL_ROWS = 15   # bx by bz r h rot(9, row-major world->local) mat
N_MAT_ROWS = 18   # kd3 ks3 kt3 ior emit3 is_light to_light rough pd_c ps_c
N_LGT_ROWS = 1    # 1 / (area * n_lights)

ROUTE_NOTE = ("render._paths_fn sends such configs and scenes to the "
                "wavefront route (integrator.trace_paths) instead")


class MegaMeta:
    """Layout of the consts table and the hit-id encoding."""

    def __init__(self, ns, nb, nc, nm, nl):
        self.ns, self.nb, self.nc, self.nm, self.nl = ns, nb, nc, nm, nl
        self.SPH = 0
        self.BOX = self.SPH + N_SPH_ROWS
        self.CYL = self.BOX + N_BOX_ROWS
        self.MAT = self.CYL + N_CYL_ROWS
        self.LGT = self.MAT + N_MAT_ROWS
        self.rows = self.LGT + N_LGT_ROWS
        # hit ids: [0, ns) sphere, [ns, ns+nb) box, [.., +nc) cylinder,
        # then BVH triangle slots (leaf*128 + lane); -1 = miss
        self.tri_base = ns + nb + nc
        # columns the kernel stages: every table's entries lie below it
        self.cols = max(ns, nb, nc, nm, nl, 1)


def mega_ok(scene, cfg) -> bool:
    """Can the segment kernel host this scene?

    The consts table is 128 columns wide (the kernel stages the columns a
    scene uses in shared memory, at most 23.5 KB), so each of the sphere,
    box, cylinder, material and light tables holds at most 128 entries.
    Triangles need the scene's BVH. There is no cap on the triangle count
    or leaf count: the kernel's walk is stackless and its trail of pending
    levels holds any 32-bit tree's depth. The kernel has no sky: a scene
    with one takes the wavefront route.
    """
    if scene.sky is not None:
        return False
    if scene.materials.ior.shape[0] > LANE:
        return False
    if (scene.spheres.radius.shape[0] > LANE
            or scene.boxes.mat.shape[0] > LANE
            or scene.cylinders.radius.shape[0] > LANE):
        return False
    if scene.lights.kind.shape[0] > LANE:
        return False
    if scene.triangles.mat.shape[0] > 0 and scene.tri_bvh is None:
        return False
    return True


def _row(x, fill=0.0):
    x = x.to(torch.float32).reshape(-1)
    return torch.cat([x, torch.full((LANE - x.shape[0],), fill,
                                    dtype=torch.float32, device=x.device)])


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def pack_consts(scene, cfg):
    """Scene tables -> ((46, 128) float32 consts, MegaMeta)."""
    sph, box, cyl, mats, lights = (
        scene.spheres, scene.boxes, scene.cylinders, scene.materials,
        scene.lights)
    ns = sph.radius.shape[0]
    nb = box.mat.shape[0]
    nc = cyl.radius.shape[0]
    nm = mats.ior.shape[0]
    nl = lights.kind.shape[0]
    meta = MegaMeta(ns, nb, nc, nm, nl)

    rows = []
    # spheres (pads far away), boxes (pads inverted)
    rows += [_row(sph.center[:, 0], PARK), _row(sph.center[:, 1], PARK),
             _row(sph.center[:, 2], PARK), _row(sph.radius, 0.0),
             _row(sph.mat, 0.0)]
    rows += [_row(box.bmin[:, 0], INF), _row(box.bmin[:, 1], INF),
             _row(box.bmin[:, 2], INF), _row(box.bmax[:, 0], -INF),
             _row(box.bmax[:, 1], -INF), _row(box.bmax[:, 2], -INF),
             _row(box.mat, 0.0)]
    # cylinders: base, radius, height, world->local rotation rows
    rows += [_row(cyl.base[:, 0], PARK), _row(cyl.base[:, 1], PARK),
             _row(cyl.base[:, 2], PARK), _row(cyl.radius, 0.0),
             _row(_norm(cyl.axis) if nc else cyl.radius, 0.0)]
    for i in range(3):
        for j in range(3):
            rows += [_row(cyl.rot[:, i, j], 1.0 if i == j else 0.0)]
    rows += [_row(cyl.mat, 0.0)]
    # materials
    if cfg.roughness_from_material:
        rough = torch.sqrt(2.0 / (mats.spec_exp + 2.0))
    else:
        rough = torch.full_like(mats.ior, cfg.default_roughness)
    ld = _norm(mats.diffuse)
    ls = _norm(mats.specular)
    lt = _norm(mats.transmission)
    s = torch.clamp(ld + ls + lt, min=1e-12)
    rows += [_row(mats.diffuse[:, k]) for k in range(3)]
    rows += [_row(mats.specular[:, k]) for k in range(3)]
    rows += [_row(mats.transmission[:, k]) for k in range(3)]
    rows += [_row(torch.clamp(mats.ior, min=1.0), 1.0)]
    rows += [_row(mats.emit[:, k]) for k in range(3)]
    rows += [_row(mats.is_light), _row(scene.mat_to_light, -1.0),
             _row(rough, 1.0), _row(ld / s), _row(ls / s)]
    # lights: the area pdf for the MIS weight of emissive BSDF hits
    if nl:
        rows += [_row(1.0 / (torch.clamp(lights.area, min=1e-12) * nl))]
    else:
        rows += [torch.zeros((LANE,), dtype=torch.float32,
                             device=mats.ior.device)]
    return torch.stack(rows).contiguous(), meta


@dataclasses.dataclass(frozen=True)
class MegaTables:
    """Scene tables in the layout both segment implementations read."""

    consts: torch.Tensor    # (46, 128) float32
    meta: MegaMeta
    tri: torch.Tensor       # (S, 12) float32 coefficient rows per slot
    tri_lm: torch.Tensor    # (S / 128, 3, 128, 4) leaf-major copy (kernel)
    sub: torch.Tensor       # (S / 128, SUB, 8) sub-leaf boxes (kernel)
    tri_mat: torch.Tensor   # (S,) int32 material per slot
    nodes: torch.Tensor     # (n_internal, 12) child AABBs per heap node
    n_leaves: int
    m_occ: int              # occupied leaves (0: no triangles)
    world_min: torch.Tensor  # (3,) for the coherence key's origin cells
    world_max: torch.Tensor  # (3,)


@profiling.spanned("mega.tables")
def prepare_tables(scene, cfg) -> MegaTables:
    consts, meta = pack_consts(scene, cfg)
    dev = consts.device
    bvh = scene.tri_bvh
    if scene.triangles.mat.shape[0] > 0:
        # the traversal kernels' tables: the BVH's sub-boxes, 8 floats a
        # row (min xyz, max xyz, 2 zeros), and the leaf-major copy
        tt = tri_tables(bvh)
        tri, tri_lm, sub, nodes = tt.tri, tt.tri_lm, tt.sub, tt.nodes
        tri_mat = bvh.mat.to(torch.int32)
        lb = bvh.leaf_bounds
        wmin, wmax = lb[0:3].min(1).values, lb[3:6].max(1).values
        n_leaves, m_occ = bvh.n_leaves, bvh.m_occ
    else:
        tri = torch.zeros((LANE, 12), dtype=torch.float32, device=dev)
        tri_lm = leaf_major(tri)
        tri_mat = torch.zeros((LANE,), dtype=torch.int32, device=dev)
        sub = torch.zeros((1, SUB, 8), dtype=torch.float32, device=dev)
        nodes = torch.zeros((1, 12), dtype=torch.float32, device=dev)
        wmin = torch.full((3,), INF, dtype=torch.float32, device=dev)
        wmax = torch.full((3,), -INF, dtype=torch.float32, device=dev)
        n_leaves, m_occ = 1, 0
    return MegaTables(
        consts=consts, meta=meta, tri=tri.contiguous(),
        tri_lm=tri_lm, sub=sub, tri_mat=tri_mat.contiguous(),
        nodes=nodes.contiguous(),
        n_leaves=n_leaves, m_occ=m_occ, world_min=wmin, world_max=wmax)


@dataclasses.dataclass(frozen=True)
class Segment:
    """Static parameters of one segment launch."""

    b_start: int          # global index of the segment's first bounce
    n_fused: int          # bounces in the segment
    t_min: float
    hit_eps: float
    rr_p: float
    rr_start: int
    do_nee: bool
    do_mis: bool
    rr_quirk: bool

    @classmethod
    def of(cls, cfg, meta: MegaMeta, b_start: int, n_fused: int):
        do_nee = bool(cfg.enable_nee and meta.nl > 0)
        return cls(b_start=b_start, n_fused=n_fused, t_min=float(cfg.t_min),
                   hit_eps=float(cfg.hit_eps),
                   rr_p=float(cfg.russian_roulette),
                   rr_start=int(cfg.rr_start_bounce), do_nee=do_nee,
                   do_mis=bool(do_nee and cfg.enable_mis),
                   rr_quirk=bool(cfg.reference_rr_quirk))


# ---------------------------------------------------------------------------
# plain version: plane helpers (a vector is a tuple of three (R,) tensors)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# plain version: the segment
# ---------------------------------------------------------------------------


def _analytic_closest(c, meta, o, d, t_min):
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

    S, B, Y = meta.SPH, meta.BOX, meta.CYL
    for j in range(meta.ns):
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
    for j in range(meta.nb):
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
        take(ok, t, n, mt, meta.ns + j)
    for j in range(meta.nc):
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
        take(ok, t, n, mt, meta.ns + meta.nb + j)
    return bt, bn, bm, bi


def _tri_sweep(tables, o, d, bound, t_min, any_hit):
    """Dense sweep over every occupied triangle slot, in chunks.

    Closest hit (any_hit False): the least (t bits with the low 7 cleared,
    slot) key among hits with t_min <= t < bound, as an int64 plane
    (INT64_MAX = none). Any hit: a bool plane, hit with t < bound.
    """
    R = o[0].shape[0]
    S = tables.m_occ * LANE
    chunk = max(LANE, min(S, ((1 << 24) // max(R, 1)) // LANE * LANE))
    big = torch.iinfo(torch.int64).max
    best = torch.full((R,), big, dtype=torch.int64, device=o[0].device)
    hit = torch.zeros((R,), dtype=torch.bool, device=o[0].device)
    col = [x[:, None] for x in (*o, *d)]
    ox, oy, oz, dx, dy, dz = col
    bnd = bound[:, None]
    for s0 in range(0, S, chunk):
        cf = tables.tri[s0:s0 + chunk].T
        s1x, s1y, s1z, c1, s2x, s2y, s2z, c2, nx, ny, nz, cw = (
            cf[k][None, :] for k in range(12))
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
        ok = (ok_w & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min) & (t < bnd))
        if any_hit:
            hit |= ok.any(dim=1)
            continue
        enc = (t.contiguous().view(torch.int32).to(torch.int64)
               & ~(LANE - 1))
        slot = torch.arange(s0, s0 + cf.shape[1], dtype=torch.int64,
                            device=t.device)[None, :]
        key = torch.where(ok, (enc << 32) | slot, big)
        best = torch.minimum(best, key.min(dim=1).values)
    return hit if any_hit else best


def _gather_mat(c, meta, mi):
    m = mi.long()
    g = lambda off: c[meta.MAT + off][m]  # noqa: E731
    return {
        "kd": (g(0), g(1), g(2)), "ks": (g(3), g(4), g(5)),
        "kt": (g(6), g(7), g(8)), "ior": g(9),
        "emit": (g(10), g(11), g(12)), "isl": g(13), "tol": g(14),
        "rough": g(15), "pd_c": g(16), "ps_c": g(17),
    }


def mega_segment_plain(state, u, ls, tables: MegaTables, seg: Segment):
    """Plain PyTorch segment: (state (11, Rp), rad (3 + 3 nf, Rp)).

    Same contract as ``mega_segment_cuda``; every ray is computed as a
    plane lane and rays dead at a bounce's start are masked out.
    """
    _check_args(state, u, ls, tables, seg)
    c, meta = tables.consts, tables.meta
    Rp = state.shape[1]
    nf = seg.n_fused
    t_min = seg.t_min
    dev = state.device
    f0 = torch.zeros((Rp,), dtype=torch.float32, device=dev)
    park = (f0 + PARK, f0 + PARK, f0 + PARK)
    o = (state[0], state[1], state[2])
    d = (state[3], state[4], state[5])
    tp = (state[6], state[7], state[8])
    prev_pdf = state[9]
    alive = state[10] > 0.5
    rad = (f0, f0, f0)
    rec_id, rec_vis, rec_alive = [], [], []

    for fb in range(nf):
        live = alive
        u_at = lambda j: u[fb * 8 + j]  # noqa: E731
        ls_at = lambda k: ls[fb * 10 + k]  # noqa: E731

        # ---- closest hit: analytic, then triangles nearer than it
        bt, bn, bm, bi = _analytic_closest(c, meta, o, d, t_min)
        if tables.m_occ > 0:
            key = _tri_sweep(tables, o, d, bt, t_min, any_hit=False)
            enc = key >> 32
            slot = (key & 0xFFFFFFFF).clamp(max=tables.tri.shape[0] - 1)
            win = (enc < INF_ENC) & live
            t_win = enc.to(torch.int32).view(torch.float32)
            cn = tables.tri[slot]
            bt = torch.where(win, t_win, bt)
            bn = vwhere(win, (cn[:, 8], cn[:, 9], cn[:, 10]), bn)
            bm = torch.where(win, tables.tri_mat[slot], bm)
            bi = torch.where(win, (meta.tri_base + slot).to(torch.int32), bi)
        t = bt
        n = vnormalize(bn, 1e-12)
        valid = t < INF
        mp = _gather_mat(c, meta, torch.where(valid, bm, 0))

        # ---- emission with MIS
        hit_light = (mp["isl"] > 0.5) & valid
        if seg.do_nee and seg.do_mis:
            tol = mp["tol"]
            has_l = (tol >= 0.0) & (tol < meta.nl)
            inv_l_hit = torch.where(
                has_l, c[meta.LGT][tol.clamp(0, LANE - 1).long()], 0.0)
            cos_l = vdot(n, vneg(d))
            p_nee = inv_l_hit * t * t / torch.clamp(torch.abs(cos_l),
                                                    min=1e-6)
            p_nee = torch.where(valid, p_nee, 0.0)
            mis_applies = (tol >= 0.0) & (prev_pdf >= 0.0)
            mis_w = torch.where(
                mis_applies,
                prev_pdf / torch.clamp(prev_pdf + p_nee, min=1e-12), 1.0)
        elif seg.do_nee:
            front = vdot(n, vneg(d)) > 1e-6
            mis_w = torch.where(
                (mp["tol"] >= 0.0) & (prev_pdf >= 0.0) & front, 0.0, 1.0)
        else:
            mis_w = f0 + 1.0
        if (seg.rr_quirk and seg.rr_p < 1.0
                and (seg.b_start + fb) > seg.rr_start):
            mis_w = mis_w * torch.where(prev_pdf >= 0.0, seg.rr_p, 1.0)
        add_emit = alive & hit_light
        rad_n = tuple(rk + torch.where(add_emit, tk * ek * mis_w, 0.0)
                      for rk, tk, ek in zip(rad, tp, mp["emit"]))

        alive_n = alive & valid & ~hit_light

        # ---- shading point
        t_safe = torch.where(valid, t, 1.0)
        x = vadd(o, vscale(t_safe - seg.hit_eps, d))
        x = vwhere(alive_n, x, o)
        wo = vneg(d)
        seg_len = torch.where(valid, t, 0.0)

        # ---- next-event estimation with the any-hit shadow test
        vis_out = f0 + 1.0
        if seg.do_nee:
            lp = (ls_at(0), ls_at(1), ls_at(2))
            ln = (ls_at(3), ls_at(4), ls_at(5))
            lemit = (ls_at(6), ls_at(7), ls_at(8))
            pdf_area = ls_at(9)
            to_l = vsub(lp, x)
            dist = torch.sqrt(torch.clamp(vdot(to_l, to_l), min=1e-18))
            wi_l = vscale(1.0 / dist, to_l)
            cos_l2 = vdot(ln, vneg(wi_l))
            p_nee_solid = pdf_area * dist * dist / torch.clamp(
                torch.abs(cos_l2), min=1e-6)
            worth = alive_n & (cos_l2 > 1e-6)
            xs = vwhere(worth, x, park)
            tfb = torch.where(worth, dist * (1.0 - 1e-3), 0.0)
            # occluded iff the nearest analytic hit is nearer than tfb
            ta, _, _, _ = _analytic_closest(c, meta, xs, wi_l, t_min)
            occ = ta < tfb
            if tables.m_occ > 0:
                occ = occ | _tri_sweep(tables, xs, wi_l,
                                       torch.where(occ, 0.0, tfb), t_min,
                                       any_hit=True)
            visible = ~occ
            vis_out = visible.to(torch.float32)
            f_l = eval_bsdf_pl(n, wi_l, wo, mp, seg_len)
            if seg.do_mis:
                p_b = pdf_bsdf_pl(n, wi_l, wo, mp)
                w_l = p_nee_solid / torch.clamp(p_nee_solid + p_b, min=1e-12)
            else:
                w_l = f0 + 1.0
            good = (alive_n & visible & (cos_l2 > 1e-6)
                    & (p_nee_solid > 1e-9))
            geom = cos_l2 / torch.clamp(dist * dist, min=1e-12)
            scale = geom * w_l / torch.clamp(pdf_area, min=1e-12)
            rad_n = tuple(
                rk + torch.where(good, tk * fk * ek * scale, 0.0)
                for rk, tk, fk, ek in zip(rad_n, tp, f_l, lemit))

        # ---- Russian roulette
        tp_n = tp
        if seg.rr_p < 1.0 and (seg.b_start + fb) >= seg.rr_start:
            alive_n = alive_n & (u_at(4) < seg.rr_p)
            tp_n = tuple(tk / seg.rr_p for tk in tp_n)

        # ---- BSDF continuation
        wi, is_trans = sample_bsdf_pl(u_at(5), u_at(6), u_at(7), n, wo, mp)
        pdf = pdf_bsdf_pl(n, wi, wo, mp)
        f = eval_bsdf_pl(n, wi, wo, mp, seg_len)
        ok_pdf = pdf > 1e-8
        upd = alive_n & ok_pdf
        inv_pdf = 1.0 / torch.clamp(pdf, min=1e-8)
        tp_n = tuple(torch.where(upd, tk * fk * inv_pdf, tk)
                     for tk, fk in zip(tp_n, f))
        alive_n = alive_n & ok_pdf
        x_next = vwhere(is_trans, vadd(o, vscale(t_safe + seg.hit_eps, d)),
                        x)

        # ---- commit the lanes that were alive at the bounce's start
        o = vwhere(live, vwhere(alive_n, x_next, park), o)
        d = vwhere(live & alive_n, wi, d)
        tp = vwhere(live, tp_n, tp)
        prev_pdf = torch.where(live, torch.where(alive_n, pdf, -1.0),
                               prev_pdf)
        rad = vwhere(live, rad_n, rad)
        alive = alive_n
        rec_id.append(torch.where(live, bi.to(torch.float32), -1.0))
        rec_vis.append(torch.where(live, vis_out, 0.0))
        rec_alive.append(alive.to(torch.float32))

    state_out = torch.stack([*o, *d, *tp, prev_pdf,
                             alive.to(torch.float32)])
    rad_out = torch.stack([*rad, *rec_id, *rec_vis, *rec_alive])
    return state_out, rad_out


# ---------------------------------------------------------------------------
# the CUDA kernel and the dispatch
# ---------------------------------------------------------------------------


def _check_args(state, u, ls, tables: MegaTables, seg: Segment):
    dev = state.device
    Rp = state.shape[1] if state.dim() == 2 else -1
    nf = seg.n_fused
    want = {"state": (state, (11, Rp)), "u": (u, (8 * nf, Rp)),
            "ls": (ls, (10 * nf, Rp)), "consts": (tables.consts, (46, LANE))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
    for name, x in (("state", state), ("u", u), ("ls", ls),
                    ("consts", tables.consts), ("tri", tables.tri),
                    ("tri_lm", tables.tri_lm), ("sub", tables.sub),
                    ("nodes", tables.nodes)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, want float32")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, state on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if tables.tri_mat.dtype != torch.int32 or tables.tri_mat.device != dev:
        raise TypeError("tri_mat must be int32 on the state's device")
    if tables.tri.shape[1] != 12 or tables.nodes.shape[1] != 12:
        raise ValueError("tri and nodes must have 12 columns")
    if tables.m_occ * LANE > tables.tri.shape[0]:
        raise ValueError("tri holds fewer slots than m_occ leaves")
    n_leaf_rows = tables.tri.shape[0] // LANE
    if tuple(tables.tri_lm.shape) != (n_leaf_rows, 3, LANE, 4):
        raise ValueError("tri_lm is not tri's leaf-major copy")
    if tuple(tables.sub.shape) != (n_leaf_rows, SUB, 8):
        raise ValueError("sub is not one row of sub-boxes per leaf")
    if not 1 <= tables.n_leaves < 1 << 31:
        raise ValueError(f"n_leaves {tables.n_leaves} outside [1, 2**31)")
    if Rp % BLOCK:
        raise ValueError(f"ray count {Rp} is not a multiple of {BLOCK}")


def group_size(seg: Segment, Rp: int) -> int:
    """Lanes per ray for a segment of Rp rays: a power of two, enough that
    the rays expected alive at its first bounce (about half die per bounce)
    fill GROUP_LANES lanes, and at most GROUP_MAX: a leaf's work, 16
    sub-box tests and then 8 triangles per box hit, fills no more lanes.
    Any choice gives the same outputs; the numbers are tuned on the H100
    (PERF.md)."""
    live = max(Rp >> min(seg.b_start, 31), 1)
    g = 1
    while g < GROUP_MAX and live * g * 2 <= GROUP_LANES:
        g *= 2
    return g


def mega_segment_cuda(state, u, ls, tables: MegaTables, seg: Segment,
                      group: int | None = None):
    """The Hopper kernel (csrc/mega.cu) on CUDA tensors; same contract as
    ``mega_segment_plain``. ``group``: lanes per ray, one of ``GROUPS``
    (default ``group_size(seg, Rp)``); it changes no output. Launches on
    the current stream, no sync."""
    global KERNEL_LAUNCHES
    if state.device.type != "cuda":
        raise ValueError(f"mega_segment_cuda needs CUDA tensors, got "
                         f"{state.device}")
    _check_args(state, u, ls, tables, seg)
    Rp = state.shape[1]
    if group is None:
        group = group_size(seg, Rp)
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    nf = seg.n_fused
    meta = tables.meta
    state_out = torch.empty_like(state)
    rad = torch.empty((3 + 3 * nf, Rp), dtype=torch.float32,
                      device=state.device)
    _kernels.launch(
        "mega", state.device, state.data_ptr(), u.data_ptr(), ls.data_ptr(),
        tables.consts.data_ptr(), tables.tri_lm.data_ptr(),
        tables.sub.data_ptr(), tables.tri_mat.data_ptr(),
        tables.nodes.data_ptr(), state_out.data_ptr(), rad.data_ptr(), Rp,
        nf, seg.b_start, seg.rr_start, tables.n_leaves, tables.m_occ,
        int(tables.m_occ > 0), meta.ns, meta.nb, meta.nc, meta.nl,
        int(seg.do_nee), int(seg.do_mis), int(seg.rr_quirk), meta.cols,
        group, seg.t_min, seg.hit_eps, seg.rr_p)
    KERNEL_LAUNCHES += 1
    return state_out, rad


def mega_segment(state, u, ls, tables: MegaTables, seg: Segment):
    """One segment: the kernel for CUDA tensors, the plain version for CPU
    tensors, an error for anything else."""
    if _kernels.takes_kernel(state.device, "segment implementation"):
        return mega_segment_cuda(state, u, ls, tables, seg)
    return mega_segment_plain(state, u, ls, tables, seg)


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------


def coherence_key(state, tables: MegaTables):
    """(dead, direction octant, 5-bit/axis origin Morton cell) int32 key:
    one stable argsort compacts dead rays to the tail and groups the
    survivors into direction- and position-coherent runs."""
    o = state[0:3]
    d = state[3:6]
    dead = (state[10] <= 0.5).to(torch.int32)
    octant = ((d[0] > 0).to(torch.int32) * 4 + (d[1] > 0).to(torch.int32) * 2
              + (d[2] > 0).to(torch.int32))
    qs = []
    for k in range(3):
        ext = torch.clamp(tables.world_max[k] - tables.world_min[k], min=1e-6)
        q = torch.clamp((o[k] - tables.world_min[k]) / ext * 32.0, 0.0, 31.0)
        qs.append(q.to(torch.int32))
    cell = torch.zeros_like(qs[0])
    for bit in range(5):
        for k in range(3):
            cell = cell * 2 + ((qs[k] >> (4 - bit)) & 1)
    return dead * (1 << 19) + octant * (1 << 16) + cell


def segment_plan(cfg):
    """[(b_start, n_fused)]: single-bounce segments while the coherence
    sort runs between bounces (b < mega_sort_after), then one fused tail."""
    B = cfg.max_bounces
    sort_after = min(B - 1, int(cfg.mega_sort_after))
    segs = []
    b = 0
    while b < B:
        nf = 1 if b < sort_after else B - b
        segs.append((b, nf))
        b += nf
    return segs, sort_after


@profiling.spanned("mega.paths")
def render_paths_mega(scene, cfg, ro, rd, keys, collect_stats=False,
                      collect_records=False, tables: MegaTables | None = None):
    """Trace R paths start to finish through the segment launches.

    ro, rd: (R, 3) float32; keys: (R, 2) int64 per-ray keys. Returns the
    radiance (R, 3); with ``collect_stats`` (radiance, alive per bounce
    (max_bounces,)); with ``collect_records`` (radiance, hit ids (B, R)
    int32, NEE visibility (B, R), alive after each bounce (B, R)), in ray
    order. The segments run where the tensors are: the kernel on CUDA, the
    plain version on the CPU. ``tables``: ``prepare_tables(scene, cfg)``,
    built here when not given; callers that launch many samples of one
    scene build it once and pass it.
    """
    if not mega_ok(scene, cfg):
        raise ValueError(
            f"scene exceeds the segment kernel's tables: {ROUTE_NOTE}")
    dev = ro.device
    if tables is None:
        tables = prepare_tables(scene, cfg)
    meta = tables.meta

    R = ro.shape[0]
    B = cfg.max_bounces
    Rp = -(-R // BLOCK) * BLOCK
    pad = Rp - R
    f32 = dict(dtype=torch.float32, device=dev)
    if pad:
        ro = torch.cat([ro, torch.full((pad, 3), PARK, **f32)])
        rd = torch.cat([rd, torch.tensor([[1.0, 0.0, 0.0]], **f32).expand(
            pad, 3)])
    do_nee = bool(cfg.enable_nee and meta.nl > 0)

    alive0 = torch.cat([torch.ones((R,), **f32), torch.zeros((pad,), **f32)])
    state = torch.cat([
        ro.T, rd.T, torch.ones((3, Rp), **f32),
        torch.full((1, Rp), -1.0, **f32), alive0[None]], 0).contiguous()
    rad_acc = torch.zeros((3, Rp), **f32)
    # inv[i] = current position of original ray i, folded per sort
    inv = torch.arange(Rp, device=dev)
    keys_cur = keys
    if pad:
        # pad keys repeat modulo R, so any pad works, pad > R included
        keys_cur = torch.cat(
            [keys, keys[torch.arange(pad, device=dev) % R]])
    counts, recs_id, recs_vis, recs_alive = [], [], [], []

    segs, sort_after = segment_plan(cfg)
    live_in = R        # rays live on entry to the next segment
    for b, nf in segs:
        with profiling.span("mega.draws"):
            u_all = rng.uniform_planes(keys_cur, b, nf, 8)
        with profiling.span("mega.lights"):
            if do_nee:
                ls_all = light_sample.sample_planes(
                    u_all, nf, scene.lights, scene.materials.emit)
            else:
                ls_all = torch.zeros((10 * nf, Rp), **f32)
        with profiling.span("mega.segment"):
            state, rad = mega_segment(state, u_all, ls_all, tables,
                                      Segment.of(cfg, meta, b, nf))
        rad_acc = rad_acc + rad[0:3]
        alive_p = rad[3 + 2 * nf:]
        if collect_records:
            back = inv[:R]
            recs_id.append(rad[3:3 + nf][:, back].to(torch.int32))
            recs_vis.append(rad[3 + nf:3 + 2 * nf][:, back])
            recs_alive.append(alive_p[:, back])
        counts.append(alive_p.sum(1))
        if profiling.enabled():
            # the kernel's lanes and the ray-bounces live on entry: the
            # rays live into the segment, then those alive after each of
            # its bounces but the last
            profiling.count("mega.lanes", Rp * nf)
            profiling.count("mega.live", live_in)
            if nf > 1:
                profiling.count("mega.live", counts[-1][:-1])
            live_in = counts[-1][-1:]
        if b + nf - 1 < sort_after:
            with profiling.span("mega.sort"):
                perm = torch.argsort(coherence_key(state, tables),
                                     stable=True)
                state = state[:, perm].contiguous()
                rad_acc = rad_acc[:, perm]
                keys_cur = keys_cur[perm]
                p_inv = torch.empty_like(perm)
                p_inv[perm] = torch.arange(Rp, device=dev)
                inv = p_inv[inv]

    radiance = rad_acc.T[inv[:R]]
    if collect_records:
        return (radiance, torch.cat(recs_id, 0), torch.cat(recs_vis, 0),
                torch.cat(recs_alive, 0))
    if collect_stats:
        return radiance, torch.cat(counts)
    return radiance
