"""The plain reference path tracer of the benchmark.

Traces chosen (pixel, sample) pairs start to finish, one bounce at a time,
in plain PyTorch on whatever device it is given, with no kernel, no BVH
and no batching rule of the program's: every ray on its own, so any subset
of a launch's rays can be traced and compared. It imports nothing of the
program and reads nothing the program made; its scene comes from the same
raw recipe arrays (``reference/scene.py``).

Frozen copies, at commit 7999567 (last changed in c7b6d06):
``generate_rays`` of ``ops/camera.py``, ``sample_lights`` of
``ops/lights.py`` (its cylinder transform written out term by term), the
bounce loop of ``ops/mega.render_paths_mega`` without its padding and its
coherence sort (neither changes a ray's result) and ``utils/math.
normalize``.

``trace(..., precision="bfloat16")`` is the control: the scene tables, the
camera rays, the light samples and the state each bounce carries on are
held in bfloat16 (rounded), the rest computed in float32 as in the
reference.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import rng
from portbench.reference.scene import KIND_CYLINDER, KIND_SPHERE, RefScene
from portbench.reference.segment import bounce

PI = 3.141592653589793


@dataclasses.dataclass(frozen=True)
class RefConfig:
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
    enable_nee: bool = True
    enable_mis: bool = True
    reference_rr_quirk: bool = False
    hit_eps: float = 1e-4
    t_min: float = 1e-6


def normalize(a, eps: float = 1e-8):
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    return a / torch.clamp(n, min=eps)


def generate_rays(cam: dict, cfg: RefConfig, pixel_ids, keys):
    """Primary rays for flat pixel ids (y = 0 the bottom row)."""
    x = (pixel_ids % cfg.width).to(torch.float32)
    y = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(
        torch.float32)
    u = rng.tagged_uniforms(keys, rng.CAMERA_TAG, 4)
    if cfg.pixel_jitter:
        x = x + u[..., 0]
        y = y + u[..., 1]
    px = 2.0 * x / cfg.width - 1.0
    py = 2.0 * y / cfg.height - 1.0
    cam_to_pixel = normalize(px[..., None] * cam["x_axis"]
                             + py[..., None] * cam["y_axis"] - cam["z_axis"])
    if not cfg.enable_dof:
        return cam["p"].expand_as(cam_to_pixel), cam_to_pixel
    anchor = torch.tensor([0.0, 0.0, cfg.focal_anchor_z],
                          dtype=torch.float32, device=cam["p"].device)
    rel = cam["p"] - anchor
    focal_len = torch.sqrt(torch.sum(rel * rel))
    focal_point = cam["p"] + focal_len * cam_to_pixel
    theta = 2.0 * PI * u[..., 2]
    if cfg.aperture_disk:
        r = cfg.aperture_radius * torch.sqrt(u[..., 3])
    else:
        r = torch.full_like(theta, cfg.aperture_radius)
    origin = (cam["p"]
              + (r * torch.cos(theta))[..., None] * cam["x_axis"]
              + (r * torch.sin(theta))[..., None] * cam["y_axis"]
              - 0.1 * cam["z_axis"])
    return origin, normalize(focal_point - origin)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _rot_t(rot, v):
    """rot^T v per row: (R, 3, 3), (R, 3) -> (R, 3)."""
    return torch.stack([rot[:, 0, i] * v[:, 0] + rot[:, 1, i] * v[:, 1]
                        + rot[:, 2, i] * v[:, 2] for i in range(3)], -1)


def sample_lights(u, lt: dict, emit_table):
    """(10, R) planes of light samples (point, normal, emit, area pdf)
    from uniforms ``u`` (R, 4): [pick, a, b, c]."""
    L = lt["kind"].shape[0]
    u_pick, u_a, u_b, u_c = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    idx = torch.clamp((u_pick * L).to(torch.int32), max=L - 1).long()
    kind = lt["kind"][idx]
    r = lt["radius"][idx]
    p0 = lt["p0"][idx]
    axis = lt["axis"][idx]
    rot = lt["rot"][idx]

    z = 1.0 - 2.0 * u_a
    phi = 2.0 * PI * u_b
    s = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    n_sph = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], -1)
    p_sph = p0 + r[..., None] * n_sph

    h = _norm(axis)
    a_lat = 2.0 * PI * r * h
    a_cap = PI * r * r
    a_tot = torch.clamp(a_lat + 2.0 * a_cap, min=1e-12)
    pick_lat = u_c < a_lat / a_tot
    pick_top = (~pick_lat) & (u_c < (a_lat + a_cap) / a_tot)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    rr = r * torch.sqrt(u_a)
    rad_l = torch.where(pick_lat, r, rr)
    zeros = torch.zeros_like(cphi)
    z_l = torch.where(pick_lat, u_a * h, torch.where(pick_top, h, zeros))
    p_local = torch.stack([rad_l * cphi, rad_l * sphi, z_l], -1)
    n_local = torch.where(
        pick_lat[..., None], torch.stack([cphi, sphi, zeros], -1),
        torch.stack([zeros, zeros,
                     torch.where(pick_top, 1.0, -1.0).to(cphi.dtype)], -1))
    p_cyl = _rot_t(rot, p_local) + p0
    n_cyl = _rot_t(rot, n_local)

    if lt["em_cdf"].shape[0] > 0:
        lo = lt["tri_lo"][idx].long()
        hi = lt["tri_hi"][idx].long()
        key = lt["cdf_base"][idx] + torch.clamp(u_a, 1e-7, 1.0 - 1e-7)
        t_idx = torch.searchsorted(lt["em_cdf"], key, right=False)
        t_idx = torch.minimum(torch.maximum(t_idx, lo),
                              torch.maximum(hi - 1, lo))
        tv0, tv1, tv2 = (lt[k][t_idx] for k in ("em_v0", "em_v1", "em_v2"))
        su = torch.sqrt(torch.clamp(u_b, 1e-12, 1.0))
        b0 = 1.0 - su
        b1 = su * (1.0 - u_c)
        p_mesh = (b0[..., None] * tv0 + b1[..., None] * tv1
                  + (1.0 - b0 - b1)[..., None] * tv2)
        n_mesh = torch.linalg.cross(tv1 - tv0, tv2 - tv0, dim=-1)
        n_mesh = n_mesh / torch.clamp(_norm(n_mesh)[..., None], min=1e-12)
    else:
        p_mesh = torch.zeros_like(p_sph)
        n_mesh = torch.zeros_like(p_sph)
        n_mesh[..., 2] = 1.0

    is_sph = (kind == KIND_SPHERE)[..., None]
    is_cyl = (kind == KIND_CYLINDER)[..., None]
    p = torch.where(is_sph, p_sph, torch.where(is_cyl, p_cyl, p_mesh))
    n = torch.where(is_sph, n_sph, torch.where(is_cyl, n_cyl, n_mesh))
    pdf_area = 1.0 / (torch.clamp(lt["area"][idx], min=1e-12) * L)
    emit = emit_table[lt["mat"][idx].long()]
    return torch.cat([p.T, n.T, emit.T, pdf_area[None]], 0)


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: (x.to(torch.bfloat16).to(torch.float32)
                          if x.is_floating_point() else x)
    raise ValueError(f"unknown precision {precision!r}")


def _held(sc: RefScene, q) -> RefScene:
    """The scene with its float tables rounded by ``q``."""
    return dataclasses.replace(
        sc, consts=q(sc.consts), tri=q(sc.tri), v0=q(sc.v0), v1=q(sc.v1),
        v2=q(sc.v2), mats={k: q(v) for k, v in sc.mats.items()},
        lights={k: q(v) for k, v in sc.lights.items()},
        camera={k: q(v) for k, v in sc.camera.items()})


def trace_block(sc: RefScene, cfg: RefConfig, pixel_ids, sample_ids, q,
                grad: bool = False):
    """Radiance (N, 3) and alive after each bounce (B, N) bool of the paths
    (pixel_ids[i], sample_ids[i]). With ``grad``, as the port's replay-
    value route: a first pass with nothing attached records each bounce's
    winners and shadow bits, and their replay (``segment.bounce`` with
    ``rec``) gives the radiance, attached to ``sc``'s tensors."""
    recs = None
    if grad:
        with torch.no_grad():
            recs = _trace(sc, cfg, pixel_ids, sample_ids, q, None)[2]
    rad, alive, _ = _trace(sc, cfg, pixel_ids, sample_ids, q, recs)
    return rad, alive


def _trace(sc, cfg, pixel_ids, sample_ids, q, recs):
    root = rng.render_key(cfg.seed, pixel_ids.device)
    do_nee = bool(cfg.enable_nee and sc.nl > 0)
    keys = rng.pixel_sample_keys(root, pixel_ids, sample_ids)
    ro, rd = generate_rays(sc.camera, cfg, pixel_ids, keys)
    ro, rd = q(ro), q(rd)
    R = pixel_ids.shape[0]
    one = torch.ones((R,), dtype=torch.float32, device=pixel_ids.device)
    st = {"o": tuple(ro.T.contiguous()), "d": tuple(rd.T.contiguous()),
          "tp": (one, one, one), "prev_pdf": -one,
          "alive": one > 0.5, "rad": (one * 0, one * 0, one * 0)}
    al, made = [], []
    for b in range(cfg.max_bounces):
        u8 = rng.tagged_uniform_planes(keys, b, 8)
        ls10 = (q(sample_lights(u8[0:4].T, sc.lights, sc.emit))
                if do_nee else torch.zeros((10, R), device=pixel_ids.device))
        st, ids, vis = bounce(sc, cfg, b, st, u8, ls10, q,
                              None if recs is None else recs[b])
        al.append(st["alive"])
        made.append((ids, vis))
    return torch.stack(st["rad"], -1), torch.stack(al, 0), made


def trace(sc: RefScene, cfg: RefConfig, pixel_ids, sample_ids,
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
