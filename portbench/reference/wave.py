"""The plain reference of the wavefront route, for scenes of spheres under
a sky.

Traces chosen (pixel, sample) pairs start to finish, one bounce at a time,
in plain PyTorch on whatever device it is given, with the semantics of the
port's wavefront route (``integrator.trace_paths`` with the brute-force
closest hit): every sphere tested, the winner's distance recomputed
exactly (``refine_hit``'s, not the segment kernel's truncated t), the
three-lobe BSDF, Russian roulette, and the sky added to a live ray that
misses. It imports nothing of the program and reads nothing the program
made: its scene comes from the raw recipe calls and the configuration's
``sky``. It hosts what ``configs/rtiow_final.json`` holds: spheres, their
materials and a sky, no light (so no next-event estimation), no box,
cylinder or triangle; ``WaveScene`` refuses anything else.

Frozen copies, at commit 5350e26: ``sphere_ts`` and ``sphere_hit_one`` of
``ops/intersect.py``, the BSDF of ``ops/bsdf.py`` (``gather_mat_params``,
``sample_bsdf``, ``pdf_bsdf``, ``eval_bsdf``), ``build_frame`` and
``frame_to_world`` of ``utils/math.py``, the bounce of
``integrator.trace_paths`` without its light terms, and ``sky_radiance``.
The threefry draws, the camera rays and the camera come from this
package's earlier reference (``reference/rng.py``, ``reference/paths.py``,
``reference/scene.py``).

``trace(..., precision="bfloat16")`` is the control: the scene tables, the
camera rays and the state each bounce carries on are held in bfloat16
(rounded), the rest computed in float32 as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.paths import _rounder, generate_rays, normalize
from portbench.reference.scene import make_camera

PI = float(np.pi)
INF = float("inf")
PARK_ORIGIN = 1e8


@dataclasses.dataclass(frozen=True)
class WaveConfig:
    """The render settings the reference reads, with RenderConfig's
    defaults (``offline_raytracer_tpu_torch/config.py``, copied)."""

    width: int = 1280
    height: int = 720
    seed: int = 0
    max_bounces: int = 12
    russian_roulette: float = 0.8
    rr_start_bounce: int = 0
    aperture_radius: float = 0.1
    focal_anchor_z: float = 0.2
    enable_dof: bool = True
    aperture_disk: bool = False
    pixel_jitter: bool = True
    default_roughness: float = 0.01
    roughness_from_material: bool = False
    hit_eps: float = 1e-4
    t_min: float = 1e-6


class WaveScene:
    """Accumulates a recipe's calls (the port's builder method names):
    materials and spheres; ``set_sky``; ``build`` -> the tensors the
    reference reads."""

    def __init__(self):
        self.mats = {"diffuse": [[0.0] * 3], "specular": [[0.0] * 3],
                     "spec_exp": [1.0], "transmission": [[0.0] * 3],
                     "ior": [1.0]}
        self.spheres = []
        self.camera = None
        self.sky = None

    def add_material(self, diffuse=(0, 0, 0), specular=(0, 0, 0),
                     spec_exp=1.0, transmission=(0, 0, 0), ior=1.0):
        for k, x in (("diffuse", list(diffuse)), ("specular", list(specular)),
                     ("spec_exp", float(spec_exp)),
                     ("transmission", list(transmission)),
                     ("ior", float(ior))):
            self.mats[k].append(x)

    def add_sphere(self, center, radius):
        self.spheres.append((list(center), float(radius),
                             len(self.mats["ior"]) - 1))

    def __getattr__(self, name):
        if name.startswith("add_"):
            raise ValueError(f"the wavefront reference hosts spheres and "
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

        sc = {k: f32(v) for k, v in self.mats.items()}
        sc["center"] = f32([s[0] for s in self.spheres]).reshape(-1, 3)
        sc["radius"] = f32([s[1] for s in self.spheres])
        sc["mat"] = torch.as_tensor(
            np.asarray([s[2] for s in self.spheres], np.int64), device=dev)
        if self.sky is not None:
            sc["sky_bottom"], sc["sky_top"], sc["sky_up"] = (
                f32(x) for x in self.sky)
        p, hr, q = self.camera
        sc["camera"] = {k: torch.as_tensor(v, device=dev) for k, v in
                        make_camera(p, hr, q, width, height).items()}
        return sc


# ---- spheres (ops/intersect.py) --------------------------------------


def _sum3(x):
    return torch.sum(x, dim=-1)


def sphere_ts(center, radius, ro, rd, t_min):
    """All-pairs sphere hit distances. ro, rd: (R, 3) -> t: (R, N)."""
    rel = ro[:, None, :] - center[None, :, :]
    b = _sum3(rd[:, None, :] * rel)
    c = _sum3(rel * rel) - radius[None, :] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tn, tp = -b - sq, -b + sq
    t = torch.where(tn >= t_min, tn, tp)
    ok = (disc > 0.0) & (t >= t_min)
    return torch.where(ok, t, INF)


def sphere_hit_one(center, radius, ro, rd, t_min):
    rel = ro - center
    b = _sum3(rd * rel)
    c = _sum3(rel * rel) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    tn, tp = -b - sq, -b + sq
    inner = tn < t_min
    t = torch.where(inner, tp, tn)
    normal = rel + t[..., None] * rd
    return t, normal


def closest(sc, ro, rd, t_min):
    """(t, unit normal, material, valid) of the closest sphere."""
    t_all = sphere_ts(sc["center"], sc["radius"], ro, rd, t_min)
    t_best, i = t_all.min(-1)
    valid = t_best < INF
    t, normal = sphere_hit_one(sc["center"][i], sc["radius"][i], ro, rd,
                               t_min)
    t = torch.where(valid, t, INF)
    normal = torch.where(valid[..., None], normal, 0.0)
    normal = normal / torch.clamp(
        torch.sqrt(torch.sum(normal * normal, -1, keepdim=True)), min=1e-12)
    mat = torch.where(valid, sc["mat"][i], 0)
    return t, normal, mat, valid


# ---- frames (utils/math.py) ------------------------------------------


def build_frame(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    near_pole = torch.abs(nz) > 0.999
    inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny, min=1e-16))
    zero = torch.zeros_like(nz)
    b_generic = torch.stack([-ny * inv, nx * inv, zero], dim=-1)
    b_pole = torch.stack([torch.ones_like(nz), zero, zero], dim=-1)
    b0 = torch.where(near_pole[..., None], b_pole, b_generic)
    t = normalize(torch.linalg.cross(b0, n, dim=-1))
    b = torch.linalg.cross(n, t, dim=-1)
    return t, b


def frame_to_world(local, n):
    t, b = build_frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


# ---- the three-lobe BSDF (ops/bsdf.py) -------------------------------


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def gather_mat(sc, mat_idx, cfg):
    ior = sc["ior"][mat_idx]
    ior = torch.maximum(ior, torch.ones_like(ior))
    if cfg.roughness_from_material:
        rough = torch.sqrt(2.0 / (sc["spec_exp"][mat_idx] + 2.0))
    else:
        rough = torch.full_like(ior, cfg.default_roughness)
    return {"kd": sc["diffuse"][mat_idx], "ks": sc["specular"][mat_idx],
            "kt": sc["transmission"][mat_idx], "ior": ior, "rough": rough}


def lobe_weights(m):
    ld, ls, lt = _length(m["kd"]), _length(m["ks"]), _length(m["kt"])
    s = torch.clamp(ld + ls + lt, min=1e-12)
    return ld / s, ls / s, lt / s


def schlick_fresnel(ks, cos_d):
    m = torch.clamp(1.0 - torch.abs(cos_d), 0.0, 1.0)
    return ks + (1.0 - ks) * (m ** 5)[..., None]


def ggx_d(n_dot_h, roughness):
    a2 = roughness ** 2
    c = torch.clamp(n_dot_h, 1e-6, 1.0)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    denom = PI * c2 * c2 * (a2 + tan2) ** 2
    d = a2 / torch.clamp(denom, min=1e-20)
    return torch.where(n_dot_h > 0.0, d, 0.0)


def smith_g1(w, n, m, roughness):
    w_dot_n = _dot(w, n)
    w_dot_m = _dot(w, m)
    same_side = (w_dot_n * w_dot_m) > 0.0
    c2 = torch.clamp(w_dot_n * w_dot_n, 1e-9, 1.0)
    tan2 = (1.0 - c2) / c2
    g = 2.0 / (1.0 + torch.sqrt(1.0 + roughness ** 2 * tan2))
    return torch.where(same_side, g, 0.0)


def _etas(n_dot_wo, ior):
    outside = n_dot_wo >= 0.0
    return torch.where(outside, 1.0, ior), torch.where(outside, ior, 1.0)


def eval_bsdf(n, wi, wo, m, distance):
    rough = m["rough"]
    n_dot_wi = _dot(wi, n)
    n_dot_wo = _dot(wo, n)
    same_side = (n_dot_wi * n_dot_wo) > 0.0
    ed = torch.where(same_side[..., None], m["kd"] / PI, 0.0)

    h = torch.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = _dot(wi, h)
    f_spec = schlick_fresnel(m["ks"], wi_dot_h)
    d_spec = ggx_d(_dot(n, h), rough)
    g_spec = smith_g1(wi, n, h, rough) * smith_g1(wo, n, h, rough)
    denom_s = 4.0 * torch.clamp(torch.abs(n_dot_wi) * torch.abs(n_dot_wo),
                                min=1e-6)
    es = f_spec * (d_spec * g_spec / denom_s)[..., None]
    h_faces_wi = wi_dot_h * torch.sign(n_dot_wi) > 0.0
    has_spec = (_dot(m["ks"], m["ks"]) > 0.0) & h_faces_wi & same_side
    es = torch.where(has_spec[..., None], es, 0.0)

    eta_wo, eta_wi = _etas(n_dot_wo, m["ior"])
    ht = -(eta_wo[..., None] * wo + eta_wi[..., None] * wi)
    mh = normalize(ht)
    mh = mh * torch.sign(_dot(mh, n))[..., None]
    wo_dot_m = _dot(wo, mh)
    wi_dot_m = _dot(wi, mh)
    eta = eta_wo / eta_wi
    lo = torch.tensor(1e-6, dtype=m["kt"].dtype)
    hi = torch.tensor(1.0, dtype=m["kt"].dtype)
    att = torch.where(
        (n_dot_wo < 0.0)[..., None],
        torch.exp(distance[..., None]
                  * torch.log(torch.minimum(torch.maximum(m["kt"], lo),
                                            hi))), 1.0)
    d_t = ggx_d(_dot(n, mh), rough)
    g_t = smith_g1(wi, n, mh, rough) * smith_g1(wo, n, mh, rough)
    f_t = 1.0 - schlick_fresnel(m["ks"], wi_dot_m)
    jac_denom = (eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2
    denom_t = torch.clamp(
        torch.abs(n_dot_wi) * torch.abs(n_dot_wo)
        * torch.clamp(jac_denom, min=1e-9), min=1e-9)
    num_t = (d_t * g_t * torch.abs(wi_dot_m) * torch.abs(wo_dot_m)
             * eta_wi ** 2)
    et_refract = torch.where((~same_side)[..., None],
                             f_t * (num_t / denom_t)[..., None], 0.0)
    radicand_h = 1.0 - eta ** 2 * (1.0 - _dot(wo, h) ** 2)
    es_tir = f_spec * (d_spec * g_spec / denom_s)[..., None]
    tir_ok = same_side & (radicand_h < 0.0) & h_faces_wi
    es_tir = torch.where(tir_ok[..., None], es_tir, 0.0)
    et = torch.where(same_side[..., None], es_tir, et_refract)
    has_trans = _dot(m["kt"], m["kt"]) > 0.0
    et = torch.where(has_trans[..., None], att * et, 0.0)
    return torch.abs(n_dot_wi)[..., None] * (ed + es + et)


def pdf_bsdf(n, wi, wo, m):
    rough = m["rough"]
    pd_c, ps_c, pt_c = lobe_weights(m)
    n_dot_wi = _dot(wi, n)
    n_dot_wo = _dot(wo, n)
    pd = torch.clamp(n_dot_wi * torch.sign(n_dot_wo), min=0.0) / PI
    same_side = (n_dot_wi * n_dot_wo) > 0.0
    h = torch.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = _dot(wi, h)
    d_spec = ggx_d(_dot(n, h), rough)
    ps = d_spec * torch.abs(_dot(n, h)) / torch.clamp(
        4.0 * torch.abs(wi_dot_h), min=1e-9)
    ps = torch.where(same_side, ps, 0.0)
    eta_wo, eta_wi = _etas(n_dot_wo, m["ior"])
    mh = normalize(-(eta_wo[..., None] * wo + eta_wi[..., None] * wi))
    mh = mh * torch.sign(_dot(mh, n))[..., None]
    wo_dot_m = _dot(wo, mh)
    wi_dot_m = _dot(wi, mh)
    eta = eta_wo / eta_wi
    d_t = ggx_d(_dot(n, mh), rough)
    jac_denom = torch.clamp((eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2,
                            min=1e-9)
    pt_refract = (d_t * torch.abs(_dot(n, mh)) * eta_wi ** 2
                  * torch.abs(wi_dot_m) / jac_denom)
    pt_refract = torch.where(same_side, 0.0, pt_refract)
    radicand_h = 1.0 - eta ** 2 * (1.0 - _dot(wo, h) ** 2)
    pt = torch.where(same_side, torch.where(radicand_h < 0.0, ps, 0.0),
                     pt_refract)
    return pd_c * pd + ps_c * ps + pt_c * pt


def sample_bsdf(u, n, wo, m):
    """(unit wi, is_transmission) from uniforms u (R, 3)."""
    rough = m["rough"]
    pd_c, ps_c, _ = lobe_weights(m)
    e0, e1, choice = u[..., 0], u[..., 1], u[..., 2]
    phi = 2.0 * PI * e1
    n_dot_wo = _dot(wo, n)
    n_face = n * torch.sign(n_dot_wo)[..., None]
    cos_d = torch.sqrt(e0)
    sin_d = torch.sqrt(torch.clamp(1.0 - e0, 0.0, 1.0))
    wi_diffuse = frame_to_world(torch.stack(
        [sin_d * torch.cos(phi), sin_d * torch.sin(phi), cos_d], -1), n_face)
    a2e = rough ** 2 * e0 / torch.clamp(1.0 - e0, min=1e-9)
    cos_m = 1.0 / torch.sqrt(1.0 + a2e)
    sin_m = torch.sqrt(torch.clamp(1.0 - cos_m ** 2, 0.0, 1.0))
    mh = frame_to_world(torch.stack(
        [sin_m * torch.cos(phi), sin_m * torch.sin(phi), cos_m], -1), n_face)
    wo_dot_m = _dot(wo, mh)
    wi_spec = 2.0 * torch.abs(wo_dot_m)[..., None] * mh - wo
    eta_wo, eta_wi = _etas(n_dot_wo, m["ior"])
    eta = eta_wo / eta_wi
    radicand = 1.0 - eta ** 2 * (1.0 - wo_dot_m ** 2)
    tir = radicand < 0.0
    sq = torch.sqrt(torch.clamp(radicand, 0.0, 1.0))
    wi_refract = (eta * wo_dot_m - sq)[..., None] * mh - eta[..., None] * wo
    wi_trans = torch.where(tir[..., None], wi_spec, wi_refract)
    pick_d = choice < pd_c
    pick_s = (~pick_d) & (choice < pd_c + ps_c)
    wi = torch.where(pick_d[..., None], wi_diffuse,
                     torch.where(pick_s[..., None], wi_spec, wi_trans))
    return normalize(wi), (~pick_d) & (~pick_s) & (~tir)


# ---- the bounce loop (integrator.trace_paths) ------------------------


def sky_radiance(sc, d):
    a = (0.5 * (torch.sum(d * sc["sky_up"], -1) + 1.0))[..., None]
    return (1.0 - a) * sc["sky_bottom"] + a * sc["sky_top"]


def _held(sc: dict, q) -> dict:
    out = {k: q(v) if torch.is_tensor(v) else v for k, v in sc.items()}
    out["camera"] = {k: q(v) for k, v in sc["camera"].items()}
    return out


def trace_block(sc, cfg: WaveConfig, pixel_ids, sample_ids, q):
    """Radiance (N, 3) and alive after each bounce (B, N) bool of the paths
    (pixel_ids[i], sample_ids[i])."""
    root = rng.render_key(cfg.seed, pixel_ids.device)
    keys = rng.pixel_sample_keys(root, pixel_ids, sample_ids)
    o, d = generate_rays(sc["camera"], cfg, pixel_ids, keys)
    o, d = q(o), q(d)
    R = pixel_ids.shape[0]
    f32 = dict(dtype=torch.float32, device=pixel_ids.device)
    tp = torch.ones((R, 3), **f32)
    rad = torch.zeros((R, 3), **f32)
    alive = torch.ones((R,), dtype=torch.bool, device=pixel_ids.device)
    sky = "sky_up" in sc
    alives = []
    for b in range(cfg.max_bounces):
        u8 = rng.bounce_uniforms(keys, b, 8)
        t, n, mat, valid = closest(sc, o, d, cfg.t_min)
        if sky:
            rad = rad + torch.where((alive & ~valid)[..., None],
                                    tp * sky_radiance(sc, d), 0.0)
        alive = alive & valid
        t_safe = torch.where(valid, t, 1.0)
        x = o + (t_safe - cfg.hit_eps)[..., None] * d
        x = torch.where(alive[..., None], x, o)
        wo = -d
        m = gather_mat(sc, torch.where(alive, mat, 0), cfg)
        seg_len = torch.where(valid, t, 0.0)
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
        tp, rad = q(tp), q(rad)
        alives.append(alive)
    return rad, torch.stack(alives, 0)


def trace(sc: dict, cfg: WaveConfig, pixel_ids, sample_ids,
          precision: str = "float32", block: int = 2048):
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
