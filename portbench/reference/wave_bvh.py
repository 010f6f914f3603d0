"""The plain reference of the wavefront route over triangles, with sphere
lights, next-event estimation and a sky.

Traces chosen (pixel, sample) pairs start to finish, one bounce at a time,
in plain PyTorch on whatever device it is given, with the semantics of the
port's wavefront route (``integrator.trace_paths`` with the BVH queries of
``ops/traverse.py``): the closest sphere by the all-pairs sweep, the
closest triangle by a brute-force sweep over every triangle (the least
(t, slot) key among hits with t_min <= t, the slots in the Morton order of
the triangles' centroids), a triangle winning only where it is strictly
nearer than the sphere, the winner's distance and normal recomputed
exactly (``refine_hit``'s), emission weighted by MIS, the sky added to a
live ray that misses, next-event estimation towards one sampled light
point with an any-hit shadow test over every sphere and every triangle up
to 0.999 of the light's distance, Russian roulette and the three-lobe
BSDF. It imports nothing of the program and reads nothing the program
made: its scene comes from the raw recipe calls, the configuration's mesh
and ``sky``. It hosts spheres (lights among them), triangles that are not
lights, their materials and a sky; ``WaveBvhScene`` refuses anything else.

Built from this package's frozen copies: the threefry draws
(``reference/rng.py``), ``generate_rays``, ``sample_lights`` and
``normalize`` (``reference/paths.py``), the triangle coefficient rows, the
Morton slot order, the light table and the camera
(``reference/scene.py``), ``triangle_hit_one`` (``reference/hits.py``),
the sphere tests, the BSDF and the sky (``reference/wave.py``), and, new
here, frozen copies at commit 356a876 of ``light_pdf_area``,
``solid_angle_pdf`` and ``mis_balance`` (``ops/lights.py``), the NEE terms
of ``integrator.shade_bounce``, the shadow ray of ``trace_paths``'
``visible_of`` and the closest-hit rule of ``traverse.make_bvh_trace_fn``.

Where it departs from the port, by design and without changing a ray's
result: it sweeps every triangle where the port culls leaves through its
BVH (a cull that drops a leaf would show); it answers only the lanes that
are live (the closest query) or worth a shadow ray (the shadow query),
which the port's queries answer as misses; it traces any subset of a
launch's rays, ``block`` rays at a time, with no coherence sort (which
changes no ray's answer).

Its settings are ``reference/paths.RefConfig``'s. ``trace(...,
precision="bfloat16")`` is the control: the scene tables, the
camera rays, the light samples and the state each bounce carries on are
held in bfloat16 (rounded), the rest computed in float32 as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.hits import triangle_hit_one
from portbench.reference.paths import (
    RefConfig, _rounder, generate_rays, normalize, sample_lights)
from portbench.reference.scene import (
    KIND_SPHERE, build_area_lights, make_camera, slot_order,
    triangle_coefficients)
from portbench.reference.wave import (
    eval_bsdf, gather_mat, pdf_bsdf, sample_bsdf, sky_radiance,
    sphere_hit_one, sphere_ts)

INF = float("inf")
PARK_ORIGIN = 1e8
_BIG = torch.iinfo(torch.int64).max
# elements of one (rays, triangles) chunk of the brute-force sweep
CHUNK = 1 << 24


class WaveBvhScene:
    """Accumulates a recipe's calls (the port's builder method names):
    materials and light materials, spheres, triangles; ``set_camera``,
    ``set_sky``; ``build`` -> the tensors the reference reads."""

    def __init__(self):
        self.mats = {"diffuse": [[0.0] * 3], "specular": [[0.0] * 3],
                     "spec_exp": [1.0], "transmission": [[0.0] * 3],
                     "ior": [1.0], "emit": [[0.0] * 3], "is_light": [False]}
        self.spheres, self.tri_v, self.tri_m, self.lights = [], [], [], []
        self.camera = None
        self.sky = None

    def _push(self, diffuse, specular, spec_exp, transmission, ior, emit,
              is_light):
        for k, x in (("diffuse", list(diffuse)), ("specular", list(specular)),
                     ("spec_exp", float(spec_exp)),
                     ("transmission", list(transmission)),
                     ("ior", float(ior)), ("emit", list(emit)),
                     ("is_light", bool(is_light))):
            self.mats[k].append(x)

    @property
    def cur(self) -> int:
        return len(self.mats["ior"]) - 1

    def add_material(self, diffuse=(0, 0, 0), specular=(0, 0, 0),
                     spec_exp=1.0, transmission=(0, 0, 0), ior=1.0):
        self._push(diffuse, specular, spec_exp, transmission, ior,
                   (0.0, 0.0, 0.0), False)

    def add_light_material(self, emit):
        self._push((0, 0, 0), (0, 0, 0), 1.0, (0, 0, 0), 1.0, emit, True)

    def add_sphere(self, center, radius):
        c = np.asarray(center, np.float32)
        self.spheres.append((c, float(radius), self.cur))
        if self.mats["is_light"][self.cur]:
            self.lights.append(dict(kind=KIND_SPHERE, mat=self.cur, p0=c,
                                    radius=float(radius)))

    def add_triangles(self, vertices, indices):
        if self.mats["is_light"][self.cur]:
            raise ValueError("the reference hosts sphere lights only")
        v = np.asarray(vertices, np.float32)[np.asarray(indices, np.int64)]
        self.tri_v.append(v)
        self.tri_m.append(np.full((v.shape[0],), self.cur, np.int64))

    def __getattr__(self, name):
        if name.startswith("add_"):
            raise ValueError(f"the reference hosts spheres, triangles and "
                             f"their materials only, not {name}")
        raise AttributeError(name)

    def set_camera(self, p, height_ratio, quat_xyzw):
        self.camera = (p, height_ratio, quat_xyzw)

    def set_sky(self, bottom, top, up=(0.0, 0.0, 1.0)):
        up = np.asarray(up, np.float64)
        self.sky = (bottom, top, up / np.linalg.norm(up))

    def build(self, width, height, device) -> dict:
        dev = torch.device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        m = self.mats
        sc = {k: f32(m[k]) for k in ("diffuse", "specular", "spec_exp",
                                     "transmission", "ior", "emit")}
        sc["is_light"] = torch.as_tensor(np.asarray(m["is_light"]),
                                         device=dev)
        mat_to_light = np.full((len(m["ior"]),), -1, np.int64)
        for li, e in enumerate(self.lights):
            mat_to_light[e["mat"]] = li
        sc["mat_to_light"] = i64(mat_to_light)
        sc["center"] = f32([s[0] for s in self.spheres]).reshape(-1, 3)
        sc["radius"] = f32([s[1] for s in self.spheres])
        sc["mat"] = i64([s[2] for s in self.spheres])
        sc["lights"] = {k: torch.as_tensor(v, device=dev) for k, v in
                        build_area_lights(self.lights).items()}
        tv = (np.concatenate(self.tri_v, 0) if self.tri_v
              else np.zeros((0, 3, 3), np.float32))
        sc["tri"] = f32(triangle_coefficients(tv[:, 0], tv[:, 1], tv[:, 2])
                        if tv.shape[0] else np.zeros((0, 12)))
        order = slot_order(tv) if tv.shape[0] else np.zeros((0,), np.int64)
        rank = np.empty_like(order)
        rank[order] = np.arange(order.shape[0])
        sc["tri_order"], sc["tri_rank"] = i64(order), i64(rank)
        sc["tri_mat"] = i64(np.concatenate(self.tri_m) if self.tri_m
                            else np.zeros((0,)))
        sc["v0"], sc["v1"], sc["v2"] = (f32(tv[:, k]) for k in range(3))
        if self.sky is not None:
            sc["sky_bottom"], sc["sky_top"], sc["sky_up"] = (
                f32(x) for x in self.sky)
        p, hr, q = self.camera
        sc["camera"] = {k: torch.as_tensor(v, device=dev) for k, v in
                        make_camera(p, hr, q, width, height).items()}
        return sc


# ---- triangles: the brute-force sweep (traverse.tri_hit_plain's test) --


def triangle_keys(sc, ro, rd, t_min, t_far, any_hit):
    """Over every triangle, for rays (R, 3) with bounds ``t_far`` (R,): the
    closest hit's key, (t bits << 32) | slot rank, int64 (R,) (``_BIG`` =
    none); with ``any_hit``, whether any triangle is hit, bool (R,). A hit
    has t_min <= t < t_far, by ``tri_hit_plain``'s arithmetic on the
    coefficient rows."""
    tri = sc["tri"]
    R, T = ro.shape[0], tri.shape[0]
    best = torch.full((R,), _BIG, dtype=torch.int64, device=ro.device)
    if T == 0 or R == 0:
        return best < _BIG if any_hit else best
    rows = max(1, min(R, CHUNK // T))
    cols = max(1, min(T, CHUNK // rows))
    for r0 in range(0, R, rows):
        ox, oy, oz = (ro[r0:r0 + rows, k:k + 1] for k in range(3))
        dx, dy, dz = (rd[r0:r0 + rows, k:k + 1] for k in range(3))
        bnd = t_far[r0:r0 + rows, None]
        part = best[r0:r0 + rows]
        for c0 in range(0, T, cols):
            cf = tri[c0:c0 + cols].T
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
                key = torch.where(ok, 0, _BIG)
            else:
                rank = sc["tri_rank"][c0:c0 + cols][None, :]
                enc = t.contiguous().view(torch.int32).to(torch.int64)
                key = torch.where(ok, (enc << 32) | rank, _BIG)
            part = torch.minimum(part, key.min(dim=1).values)
        best[r0:r0 + rows] = part
    return best < _BIG if any_hit else best


def _on(mask, fn, fill):
    """``fn(index)`` on the lanes ``mask`` marks, ``fill`` elsewhere."""
    idx = mask.nonzero(as_tuple=True)[0]
    out = fill.clone()
    if idx.numel():
        out[idx] = fn(idx)
    return out


def closest(sc, ro, rd, alive, t_min):
    """(t, unit normal, material, valid) of each live ray's closest hit:
    the spheres' winner (the first of equals), then a triangle where it is
    strictly nearer, the winner recomputed exactly; a dead ray misses."""
    R = ro.shape[0]
    dev = ro.device
    t_s = torch.full((R,), INF, device=dev)
    i_s = torch.zeros((R,), dtype=torch.int64, device=dev)
    if sc["radius"].shape[0]:
        t_s, i_s = sphere_ts(sc["center"], sc["radius"], ro, rd,
                             t_min).min(-1)
        t_s = torch.where(alive, t_s, INF)
    inf_r = torch.full((R,), INF, device=dev)
    key = _on(alive, lambda i: triangle_keys(sc, ro[i], rd[i], t_min,
                                             inf_r[i], False),
              torch.full((R,), _BIG, dtype=torch.int64, device=dev))
    has_tri = key < _BIG
    t_tri = torch.where(has_tri, (key >> 32).to(torch.int32).view(
        torch.float32), INF)
    # the winning slot's place in the slot order -> its triangle
    T = sc["tri"].shape[0]
    j = (sc["tri_order"][torch.where(has_tri, key & 0xFFFFFFFF, 0)] if T
         else key)
    tri_wins = has_tri & (t_tri < t_s)
    valid = tri_wins | (t_s < INF)

    t = torch.full((R,), INF, device=dev)
    normal = torch.zeros((R, 3), device=dev)
    mat = torch.zeros((R,), dtype=torch.int64, device=dev)
    if sc["radius"].shape[0]:
        ts, ns = sphere_hit_one(sc["center"][i_s], sc["radius"][i_s], ro, rd,
                                t_min)
        sel = valid & ~tri_wins
        t = torch.where(sel, ts, t)
        normal = torch.where(sel[..., None], ns, normal)
        mat = torch.where(sel, sc["mat"][i_s], mat)
    if T:
        tt, nt = triangle_hit_one(sc["v0"][j], sc["v1"][j], sc["v2"][j], ro,
                                  rd, t_min)
        t = torch.where(tri_wins, tt, t)
        normal = torch.where(tri_wins[..., None], nt, normal)
        mat = torch.where(tri_wins, sc["tri_mat"][j], mat)
    normal = normal / torch.clamp(
        torch.sqrt(torch.sum(normal * normal, -1, keepdim=True)), min=1e-12)
    return t, normal, torch.where(valid, mat, 0), valid


def occluded(sc, ro, rd, t_far, t_min):
    """(R,) bool: a sphere or a triangle at t_min <= t < t_far (a ray with
    t_far <= t_min is dead and never occluded)."""
    hit = torch.zeros(ro.shape[:1], dtype=torch.bool, device=ro.device)
    if sc["radius"].shape[0]:
        hit = (sphere_ts(sc["center"], sc["radius"], ro, rd, t_min)
               < t_far[:, None]).any(-1)
    live = ~hit & (t_far > t_min)
    tf = torch.where(hit, 0.0, t_far)
    tri = _on(live, lambda i: triangle_keys(sc, ro[i], rd[i], t_min, tf[i],
                                            True), torch.zeros_like(hit))
    return hit | tri


# ---- the light terms (ops/lights.py) -----------------------------------


def light_pdf_area(lights, light_idx):
    L = lights["kind"].shape[0]
    i = torch.clamp(light_idx.long(), 0, max(L - 1, 0))
    return 1.0 / (torch.clamp(lights["area"][i], min=1e-12) * max(L, 1))


def solid_angle_pdf(pdf_area, dist, cos_light):
    return pdf_area * dist ** 2 / torch.clamp(torch.abs(cos_light), min=1e-6)


def mis_balance(p_a, p_b):
    return p_a / torch.clamp(p_a + p_b, min=1e-12)


# ---- the bounce loop (integrator.trace_paths, shade_bounce) -------------


def _held(sc: dict, q) -> dict:
    out = {k: q(v) if torch.is_tensor(v) else v for k, v in sc.items()}
    out["camera"] = {k: q(v) for k, v in sc["camera"].items()}
    out["lights"] = {k: q(v) for k, v in sc["lights"].items()}
    return out


def trace_block(sc, cfg: RefConfig, pixel_ids, sample_ids, q):
    """Radiance (N, 3) and alive after each bounce (B, N) bool of the paths
    (pixel_ids[i], sample_ids[i])."""
    if cfg.reference_rr_quirk:
        raise ValueError("the wavefront reference has no reference_rr_quirk")
    root = rng.render_key(cfg.seed, pixel_ids.device)
    keys = rng.pixel_sample_keys(root, pixel_ids, sample_ids)
    o, d = generate_rays(sc["camera"], cfg, pixel_ids, keys)
    o, d = q(o), q(d)
    R = pixel_ids.shape[0]
    f32 = dict(dtype=torch.float32, device=pixel_ids.device)
    tp = torch.ones((R, 3), **f32)
    rad = torch.zeros((R, 3), **f32)
    alive = torch.ones((R,), dtype=torch.bool, device=pixel_ids.device)
    prev_pdf = torch.full((R,), -1.0, **f32)
    lights = sc["lights"]
    do_nee = cfg.enable_nee and lights["kind"].shape[0] > 0
    do_mis = do_nee and cfg.enable_mis
    sky = "sky_up" in sc
    alives = []
    for b in range(cfg.max_bounces):
        u8 = rng.bounce_uniforms(keys, b, 8)
        t, n, mat, valid = closest(sc, o, d, alive, cfg.t_min)
        emit = sc["emit"][mat]
        light_idx = sc["mat_to_light"][mat]
        hit_light = sc["is_light"][mat] & valid

        # emission, MIS-weighted against NEE's pdf of the light hit
        if do_mis:
            cos_l = torch.sum(n * (-d), -1)
            p_nee = solid_angle_pdf(light_pdf_area(lights, light_idx), t,
                                    cos_l)
            mis_w = torch.where((light_idx >= 0) & (prev_pdf >= 0.0),
                                mis_balance(prev_pdf, p_nee), 1.0)
        elif do_nee:
            front = torch.sum(n * (-d), -1) > 1e-6
            mis_w = torch.where((light_idx >= 0) & (prev_pdf >= 0.0)
                                & front, 0.0, 1.0)
        else:
            mis_w = torch.ones((R,), **f32)
        rad = rad + torch.where((alive & hit_light)[..., None],
                                tp * emit * mis_w[..., None], 0.0)
        if sky:
            rad = rad + torch.where((alive & ~valid)[..., None],
                                    tp * sky_radiance(sc, d), 0.0)
        alive = alive & valid & ~hit_light

        t_safe = torch.where(valid, t, 1.0)
        x = o + (t_safe - cfg.hit_eps)[..., None] * d
        x = torch.where(alive[..., None], x, o)
        wo = -d
        m = gather_mat(sc, mat, cfg)
        seg_len = torch.where(valid, t, 0.0)

        # next-event estimation towards one sampled light point
        if do_nee:
            ls = q(sample_lights(u8[:, 0:4], lights, sc["emit"]))
            lp, ln, lemit, pdf_area = ls[0:3].T, ls[3:6].T, ls[6:9].T, ls[9]
            to_l = lp - x
            dist_l = torch.sqrt(torch.sum(to_l * to_l, -1))
            wi_l = to_l / torch.clamp(dist_l, min=1e-9)[..., None]
            cos_l = torch.sum(ln * (-wi_l), -1)
            p_nee_solid = solid_angle_pdf(pdf_area, dist_l, cos_l)
            worth = alive & (cos_l > 1e-6)
            x_sh = torch.where(worth[..., None], x, PARK_ORIGIN)
            tf = torch.where(worth, dist_l * (1.0 - 1e-3), 0.0)
            visible = ~occluded(sc, x_sh, wi_l, tf, cfg.t_min)
            f_l = eval_bsdf(n, wi_l, wo, m, seg_len)
            if do_mis:
                w_l = mis_balance(p_nee_solid, pdf_bsdf(n, wi_l, wo, m))
            else:
                w_l = torch.ones((R,), **f32)
            good = alive & visible & (cos_l > 1e-6) & (p_nee_solid > 1e-9)
            geom = cos_l / torch.clamp(dist_l * dist_l, min=1e-12)
            contrib = (tp * f_l * lemit
                       * (geom * w_l / torch.clamp(pdf_area, min=1e-12))[
                           ..., None])
            rad = rad + torch.where(good[..., None], contrib, 0.0)

        if cfg.russian_roulette < 1.0 and b >= cfg.rr_start_bounce:
            alive = alive & (u8[:, 4] < cfg.russian_roulette)
            tp = tp / cfg.russian_roulette
        wi, is_trans = sample_bsdf(u8[:, 5:8], n, wo, m)
        wi = normalize(wi)
        pdf = pdf_bsdf(n, wi, wo, m)
        f = eval_bsdf(n, wi, wo, m, seg_len)
        ok_pdf = pdf > 1e-8
        tp = torch.where((alive & ok_pdf)[..., None],
                         tp * f / torch.clamp(pdf, min=1e-8)[..., None], tp)
        alive = alive & ok_pdf
        x_next = torch.where(is_trans[..., None],
                             o + (t_safe + cfg.hit_eps)[..., None] * d, x)
        o = q(torch.where(alive[..., None], x_next, PARK_ORIGIN))
        d = q(torch.where(alive[..., None], wi, d))
        prev_pdf = q(torch.where(alive, pdf, -1.0))
        tp, rad = q(tp), q(rad)
        alives.append(alive)
    return rad, torch.stack(alives, 0)


def trace(sc: dict, cfg: RefConfig, pixel_ids, sample_ids,
          precision: str = "float32", block: int = 8192):
    """Radiance (N, 3) and alive after each bounce (B, N) bool of the paths
    (pixel_ids[i], sample_ids[i]), traced ``block`` rays at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = _rounder(precision)
    sc = _held(sc, q)
    rads, alives = [], []
    with torch.no_grad():
        for lo in range(0, pixel_ids.shape[0], block):
            r, a = trace_block(sc, cfg, pixel_ids[lo:lo + block],
                               sample_ids[lo:lo + block], q)
            rads.append(r)
            alives.append(a)
    return torch.cat(rads, 0), torch.cat(alives, 1)
