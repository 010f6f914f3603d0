"""Wavefront path-tracing integrator (counterpart of
``offline_raytracer_tpu/integrator.py``, its non-replay branch).

A whole wavefront of rays advances bounce by bounce through a Python loop
over ``max_bounces`` (the JAX package's ``lax.scan`` body), with an alive
mask: Russian roulette ends paths through the mask with 1/p throughput
compensation, and dead rays are parked far outside the scene. Each bounce
draws its uniforms with ``rng.bounce_uniforms(keys, b, 8)`` in the JAX
column layout ([0] light pick, [1:4] light point, [4] RR, [5:8] BSDF
sample), so both packages trace the same paths draw for draw.

Differentiable under autograd: hit winners and sampled directions are
detached; hit geometry, BSDF values and light terms stay attached, and so
do the geometric factor and area pdf of the NEE estimator. Sampling pdfs
and MIS weights are detached. Masked lanes follow the double-``where``
discipline (a finite dummy t on a miss), since ``torch.where`` passes NaN
gradients from the unselected branch just as ``jnp.where`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from offline_raytracer_tpu_torch.ops import bsdf as bsdf_ops
from offline_raytracer_tpu_torch.ops import lights as light_ops
from offline_raytracer_tpu_torch.ops.intersect import closest_hit_bruteforce
from offline_raytracer_tpu_torch.utils import rng
from offline_raytracer_tpu_torch.utils.math import normalize

# where terminated lanes are parked: far outside any scene box, small
# enough that squared terms of the analytic tests stay finite in float32
PARK_ORIGIN = 1e8

ROADMAP_REPLAY = ("replay of recorded hits is not ported yet (ROADMAP "
                  "queue A8)")


@dataclasses.dataclass(frozen=True)
class PathState:
    origin: torch.Tensor      # (R, 3)
    direction: torch.Tensor   # (R, 3)
    throughput: torch.Tensor  # (R, 3)
    radiance: torch.Tensor    # (R, 3)
    alive: torch.Tensor       # (R,) bool
    prev_pdf: torch.Tensor    # (R,) BSDF pdf of the ray that made this
    #                           segment; -1 = camera ray (MIS weight 1)
    keys: torch.Tensor        # (R, 2) per-path keys


def make_brute_trace_fn(scene, cfg):
    def trace(ro, rd):
        return closest_hit_bruteforce(scene, ro, rd, cfg.t_min)
    return trace


def trace_paths(scene, cfg, trace_fn, origin, direction, ps_keys,
                collect_stats: bool = False, occl_fn=None, replay=None):
    """Trace R paths to completion; radiance (R, 3).

    With ``collect_stats`` returns ``(radiance, alive_per_bounce)``: the
    number of lanes that made a continuation at each bounce, (max_bounces,)
    float32. ``occl_fn(ro, rd, t_far) -> occluded`` answers the NEE shadow
    queries; without it they go through ``trace_fn``.
    """
    if replay is not None:
        raise NotImplementedError(ROADMAP_REPLAY)
    R = origin.shape[0]
    dev = origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    state = PathState(
        origin=origin, direction=direction,
        throughput=torch.ones((R, 3), **f32),
        radiance=torch.zeros((R, 3), **f32),
        alive=torch.ones((R,), dtype=torch.bool, device=dev),
        prev_pdf=torch.full((R,), -1.0, **f32), keys=ps_keys)

    mats = scene.materials
    do_nee = cfg.enable_nee and scene.n_lights > 0
    do_mis = do_nee and cfg.enable_mis
    counts = []

    for bounce_idx in range(cfg.max_bounces):
        u8 = rng.bounce_uniforms(state.keys, bounce_idx, 8)
        hit = trace_fn(state.origin, state.direction)
        mat_i = hit.mat.long()
        emit = mats.emit[mat_i]
        hit_light = mats.is_light[mat_i] & hit.valid

        # ---- emission (implicit light connection)
        if do_mis:
            light_idx = scene.mat_to_light[mat_i]
            pdf_area = light_ops.light_pdf_area(scene.lights, light_idx)
            cos_l = torch.sum(hit.normal * (-state.direction), -1)
            p_nee = light_ops.solid_angle_pdf(pdf_area, hit.t, cos_l)
            mis_applies = (light_idx >= 0) & (state.prev_pdf >= 0.0)
            mis_w = torch.where(
                mis_applies, light_ops.mis_balance(state.prev_pdf, p_nee),
                1.0)
        elif do_nee:
            # NEE without MIS: an emitter found by a sampled continuation
            # is integrated by the explicit connection already, unless it
            # is back-facing (NEE only samples front faces)
            light_idx = scene.mat_to_light[mat_i]
            front = torch.sum(hit.normal * (-state.direction), -1) > 1e-6
            mis_w = torch.where(
                (light_idx >= 0) & (state.prev_pdf >= 0.0) & front, 0.0, 1.0)
        else:
            mis_w = torch.ones((R,), **f32)
        if cfg.reference_rr_quirk and cfg.russian_roulette < 1.0:
            # the reference's uncompensated final RR gate on light-
            # terminated paths, only after a bounce that ran an RR gate
            if bounce_idx > cfg.rr_start_bounce:
                mis_w = mis_w * torch.where(state.prev_pdf >= 0.0,
                                            cfg.russian_roulette, 1.0)
        add_emit = state.alive & hit_light
        radiance = state.radiance + torch.where(
            add_emit[..., None],
            state.throughput * emit * mis_w.detach()[..., None], 0.0)

        alive = state.alive & hit.valid & ~hit_light

        # ---- surface interaction: backed-off hit point; a miss gets a
        # finite dummy t so no inf enters the graph
        t_safe = torch.where(hit.valid, hit.t, 1.0)
        x = state.origin + (t_safe - cfg.hit_eps)[..., None] * state.direction
        x = torch.where(alive[..., None], x, state.origin)
        wo = -state.direction
        n = hit.normal
        safe_mat = torch.where(alive, hit.mat, 0)
        matp = bsdf_ops.gather_mat_params(
            mats, safe_mat, cfg.default_roughness,
            cfg.roughness_from_material)
        seg_len = torch.where(hit.valid, hit.t, 0.0)

        # ---- next-event estimation
        if do_nee:
            ls = light_ops.sample_lights(u8[:, 0:4], scene.lights, mats.emit)
            to_l = ls.p - x
            dist_l = torch.sqrt(torch.sum(to_l * to_l, -1))
            wi_l = to_l / torch.clamp(dist_l, min=1e-9)[..., None]
            cos_l = torch.sum(ls.normal * (-wi_l), -1)
            p_nee_solid = light_ops.solid_angle_pdf(ls.pdf_area, dist_l,
                                                    cos_l)
            # shadow query with the light distance as the bound; dead
            # lanes launch with t_far = 0 and cost nothing
            worth = alive & (cos_l > 1e-6)
            if occl_fn is not None:
                x_sh = torch.where(worth[..., None], x, PARK_ORIGIN)
                tf = torch.where(worth, dist_l * (1.0 - 1e-3), 0.0)
                visible = ~occl_fn(x_sh.detach(), wi_l.detach(), tf.detach())
            else:
                sh = trace_fn(x, wi_l)
                visible = sh.t >= dist_l * (1.0 - 1e-3)
            f_l = bsdf_ops.eval_bsdf(n, wi_l, wo, matp, seg_len)
            if do_mis:
                p_b = bsdf_ops.pdf_bsdf(n, wi_l, wo, matp)
                w_l = light_ops.mis_balance(p_nee_solid, p_b)
            else:
                w_l = torch.ones((R,), **f32)
            good = alive & visible & (cos_l > 1e-6) & (p_nee_solid > 1e-9)
            # cos/dist^2 and the area pdf stay attached (they carry the
            # derivatives in shading and light geometry); only the MIS
            # weight is detached
            geom = cos_l / torch.clamp(dist_l * dist_l, min=1e-12)
            contrib = (state.throughput * f_l * ls.emit
                       * (geom * w_l.detach()
                          / torch.clamp(ls.pdf_area, min=1e-12))[..., None])
            radiance = radiance + torch.where(good[..., None], contrib, 0.0)

        # ---- Russian roulette
        throughput = state.throughput
        if cfg.russian_roulette < 1.0 and bounce_idx >= cfg.rr_start_bounce:
            alive = alive & (u8[:, 4] < cfg.russian_roulette)
            throughput = throughput / cfg.russian_roulette

        # ---- BSDF continuation
        samp = bsdf_ops.sample_bsdf(u8[:, 5:8], n, wo, matp)
        wi = normalize(samp.wi).detach()
        pdf = bsdf_ops.pdf_bsdf(n, wi, wo, matp).detach()
        f = bsdf_ops.eval_bsdf(n, wi, wo, matp, seg_len)
        ok_pdf = pdf > 1e-8
        throughput = torch.where(
            (alive & ok_pdf)[..., None],
            throughput * f / torch.clamp(pdf, min=1e-8)[..., None],
            throughput)
        alive = alive & ok_pdf

        # transmission pushes through the surface instead of backing off
        x_next = torch.where(
            samp.is_transmission[..., None],
            state.origin + (t_safe + cfg.hit_eps)[..., None] * state.direction,
            x)

        state = PathState(
            origin=torch.where(alive[..., None], x_next, PARK_ORIGIN),
            direction=torch.where(alive[..., None], wi, state.direction),
            throughput=throughput, radiance=radiance, alive=alive,
            prev_pdf=torch.where(alive, pdf, -1.0), keys=state.keys)
        counts.append(alive.sum(dtype=torch.float32))

    if collect_stats:
        return state.radiance, torch.stack(counts)
    return state.radiance
