"""Wavefront path-tracing integrator (counterpart of
``offline_raytracer_tpu/integrator.py``).

A whole wavefront of rays advances bounce by bounce through a Python loop
over ``max_bounces`` (the JAX package's ``lax.scan`` body), with an alive
mask: Russian roulette ends paths through the mask with 1/p throughput
compensation, and dead rays are parked far outside the scene. Each bounce
draws its uniforms with ``rng.bounce_uniforms(keys, b, 8)`` in the JAX
column layout ([0] light pick, [1:4] light point, [4] RR, [5:8] BSDF
sample), so both packages trace the same paths draw for draw.

A live ray that misses reaches the scene's sky when it has one
(``scene.types.Sky``), added with MIS weight 1 as NEE never samples it;
without a sky a miss ends the path with nothing added, and no operation of
the sky's runs. On the card, the forward route shades a bounce without NEE
in one launch of ``csrc/wave_shade.cu`` (``ops/wave_shade.py``), bitwise
the eager body, when no gradient is wanted; the CPU, the replay, autograd
and NEE run the eager body. While the recorder of ``utils/profiling.py``
is on, each bounce is spans ``wave.hit`` (the closest-hit query, or the
replay's recompute of the recorded winner), ``wave.shade`` (the rest, the
shadow query in ``wave.occlusion`` within it) and counts ``wave.lanes``
(lanes the bounce runs), ``wave.live`` (lanes live on entry),
``wave.escaped`` (live rays that missed) and ``wave.shade_kernel`` (lanes
the kernel shaded).

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

from offline_raytracer_tpu_torch.ops import _kernels, wave_shade
from offline_raytracer_tpu_torch.ops import bsdf as bsdf_ops
from offline_raytracer_tpu_torch.ops import lights as light_ops
from offline_raytracer_tpu_torch.ops.intersect import (
    closest_hit_bruteforce, hit_from_params, prefetch_hit_params)
from offline_raytracer_tpu_torch.scene.types import float_leaves
from offline_raytracer_tpu_torch.utils import profiling, rng
from offline_raytracer_tpu_torch.utils.math import normalize

# where terminated lanes are parked: far outside any scene box, small
# enough that squared terms of the analytic tests stay finite in float32
PARK_ORIGIN = 1e8


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


def sky_radiance(sky, direction):
    """(R, 3) radiance of ``scene.types.Sky`` seen along unit directions
    (R, 3): (1 - a) bottom + a top, a = (d.up + 1) / 2."""
    a = (0.5 * (torch.sum(direction * sky.up, -1) + 1.0))[..., None]
    return (1.0 - a) * sky.bottom + a * sky.top


def wants_grad(scene, ro, rd) -> bool:
    """Would autograd record a graph through these rays or the scene?"""
    return torch.is_grad_enabled() and (
        ro.requires_grad or rd.requires_grad
        or any(x.requires_grad for _, x in float_leaves(scene)))


def make_brute_trace_fn(scene, cfg):
    """Closest-hit function (ro, rd, alive=None) -> Hit by the brute-force
    sweep. ``alive`` (R,) bool marks the lanes whose hit is wanted: on the
    card the sphere kernel answers the others as misses without testing
    them (nothing downstream reads a dead lane's hit); the plain sweeps
    answer every lane. The NEE shadow query passes no mask."""
    def trace(ro, rd, alive=None):
        return closest_hit_bruteforce(scene, ro, rd, cfg.t_min, alive=alive)
    return trace


def _map(fn, tree):
    """``fn`` applied to every tensor in a nest of dicts and dataclasses."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def _at(tree, i):
    """Index ``i`` of the leading axis of every tensor in a nest."""
    return _map(lambda x: x[i], tree)


def surface_record(scene, cfg, u8, mat):
    """What the shading reads of the surfaces a bounce hit, the same for
    the forward route and the replay: the bounce's uniforms ``u8`` (...,
    8) and every gather by the hits' materials ``mat`` (...) int, 0 on a
    miss: ``matp``, ``emit``, ``is_light``, ``light_idx`` and, where NEE
    and MIS want them, ``pdf_area_hit`` (NEE's area pdf of the light hit)
    and ``ls`` (the NEE light sample), each with ``mat``'s shape in front.
    A dead lane's entries only need to be finite: every use of them is
    alive-masked."""
    mats = scene.materials
    do_nee = cfg.enable_nee and scene.n_lights > 0
    m = mat.long()
    rec = {
        "u8": u8,
        "matp": bsdf_ops.gather_mat_params(
            mats, m, cfg.default_roughness, cfg.roughness_from_material),
        "emit": mats.emit[m], "is_light": mats.is_light[m],
        "light_idx": scene.mat_to_light[m],
    }
    if do_nee and cfg.enable_mis:
        rec["pdf_area_hit"] = light_ops.light_pdf_area(scene.lights,
                                                       rec["light_idx"])
    if do_nee:
        lead = m.shape
        u4 = u8[..., 0:4]
        if len(lead) > 1:       # sample_lights takes (R, 4)
            u4 = u4.reshape(-1, 4)
        ls = light_ops.sample_lights(u4, scene.lights, mats.emit)
        if len(lead) > 1:
            ls = _map(lambda x: x.reshape(lead + x.shape[1:]), ls)
        rec["ls"] = ls
    return rec


def _replay_tables(scene, cfg, ids, vis, keys, b_lo):
    """The replay's records for bounces [b_lo, b_lo + nb) of the current
    (possibly compacted) rays, built once per segment so the gathers, and
    the scatter-adds of their backward that carry the parameter gradients,
    are sized to the segment's width: the winners' geometry ``hp``, the
    ``surface_record`` ``surf`` and the NEE visibility ``vis``. ids, vis:
    (nb, S). Every tensor has (nb, S) in front."""
    nb = ids.shape[0]
    hp = prefetch_hit_params(scene, ids)
    u8 = torch.stack([rng.bounce_uniforms(keys, b_lo + i, 8)
                      for i in range(nb)])
    return {"hp": hp, "surf": surface_record(scene, cfg, u8, hp["mat"]),
            "vis": vis}


def shade_bounce(scene, cfg, state, bounce_idx, hit, surf,
                 visible_of=None):
    """One bounce's shading in eager PyTorch operations: the emission a
    live ray's hit adds (MIS-weighted), the sky a live miss reaches, NEE
    with its shadow query ``visible_of(x, wi_l, dist_l, worth) -> visible``
    (read only when the scene has lights and ``cfg.enable_nee``), Russian
    roulette and the BSDF continuation, given the bounce's ``Hit`` and its
    ``surface_record``; the next ``PathState``. The CPU route, the replay,
    autograd and NEE run it; it is the twin the shading kernel
    (``ops/wave_shade.py``) is held to on the card."""
    R_cur = state.alive.shape[0]     # replay tiers shrink the batch
    f32 = dict(dtype=torch.float32, device=state.alive.device)
    do_nee = cfg.enable_nee and scene.n_lights > 0
    do_mis = do_nee and cfg.enable_mis
    u8 = surf["u8"]
    emit = surf["emit"]
    light_idx = surf["light_idx"]
    hit_light = surf["is_light"] & hit.valid

    # ---- emission (implicit light connection)
    if do_mis:
        pdf_area = surf["pdf_area_hit"]
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
        front = torch.sum(hit.normal * (-state.direction), -1) > 1e-6
        mis_w = torch.where(
            (light_idx >= 0) & (state.prev_pdf >= 0.0) & front, 0.0, 1.0)
    else:
        mis_w = torch.ones((R_cur,), **f32)
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

    # ---- the sky: a live ray that misses (a recorded id of -1 in the
    # replay) reaches it; NEE never samples it, so its MIS weight is 1
    escaped = None
    if scene.sky is not None:
        escaped = state.alive & ~hit.valid
        radiance = radiance + torch.where(
            escaped[..., None],
            state.throughput * sky_radiance(scene.sky, state.direction),
            0.0)
    if profiling.enabled():
        if escaped is None:
            escaped = state.alive & ~hit.valid
        profiling.count("wave.escaped", escaped.sum(dtype=torch.float32))

    alive = state.alive & hit.valid & ~hit_light

    # ---- surface interaction: backed-off hit point; a miss gets a
    # finite dummy t so no inf enters the graph
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    x = state.origin + (t_safe - cfg.hit_eps)[..., None] * state.direction
    x = torch.where(alive[..., None], x, state.origin)
    wo = -state.direction
    n = hit.normal
    matp = surf["matp"]
    seg_len = torch.where(hit.valid, hit.t, 0.0)

    # ---- next-event estimation
    if do_nee:
        ls = surf["ls"]
        to_l = ls.p - x
        dist_l = torch.sqrt(torch.sum(to_l * to_l, -1))
        wi_l = to_l / torch.clamp(dist_l, min=1e-9)[..., None]
        cos_l = torch.sum(ls.normal * (-wi_l), -1)
        p_nee_solid = light_ops.solid_angle_pdf(ls.pdf_area, dist_l,
                                                cos_l)
        # shadow query with the light distance as the bound
        worth = alive & (cos_l > 1e-6)
        visible = visible_of(x, wi_l, dist_l, worth)
        f_l = bsdf_ops.eval_bsdf(n, wi_l, wo, matp, seg_len)
        if do_mis:
            p_b = bsdf_ops.pdf_bsdf(n, wi_l, wo, matp)
            w_l = light_ops.mis_balance(p_nee_solid, p_b)
        else:
            w_l = torch.ones((R_cur,), **f32)
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

    return PathState(
        origin=torch.where(alive[..., None], x_next, PARK_ORIGIN),
        direction=torch.where(alive[..., None], wi, state.direction),
        throughput=throughput, radiance=radiance, alive=alive,
        prev_pdf=torch.where(alive, pdf, -1.0), keys=state.keys)


def trace_paths(scene, cfg, trace_fn, origin, direction, ps_keys,
                collect_stats: bool = False, occl_fn=None, replay=None):
    """Trace R paths to completion; radiance (R, 3).

    With ``collect_stats`` returns ``(radiance, alive_per_bounce)``: the
    number of lanes that made a continuation at each bounce, (max_bounces,)
    float32. ``occl_fn(ro, rd, t_far) -> occluded`` answers the NEE shadow
    queries; without it they go through ``trace_fn``.

    ``replay``: ``(hit ids (B, R) int32, NEE visibility (B, R))`` records
    of the segment kernel (``mega.render_paths_mega(collect_records=True)``).
    Then nothing is traversed: each bounce's hit is recomputed attached from
    the recorded winner (``intersect.hit_from_params``) and the shadow test
    is the recorded bit. The counter-based draws regenerate every sampled
    direction, RR decision and light point, so this replays the paths the
    kernel traced, differentiably (path-replay backprop); ``trace_fn`` and
    ``occl_fn`` may be None. ``cfg.replay_tiers`` ((bounce, divisor), ...)
    compacts the replay: at each listed bounce it banks the radiance so far
    and keeps the first R // divisor rays that hit at the previous bounce
    (stable order), which is exact while the survivors fit.
    """
    R = origin.shape[0]
    dev = origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    state = PathState(
        origin=origin, direction=direction,
        throughput=torch.ones((R, 3), **f32),
        radiance=torch.zeros((R, 3), **f32),
        alive=torch.ones((R,), dtype=torch.bool, device=dev),
        prev_pdf=torch.full((R,), -1.0, **f32), keys=ps_keys)

    do_nee = cfg.enable_nee and scene.n_lights > 0

    # where a bounce's hit, surface record and NEE visibility come from:
    # the forward route queries and draws; the replay reads ``rec``, its
    # records of the bounce being shaded, which the replay loop sets
    if replay is None:
        def hit_of(state):
            # finished lanes go to the query dead (t_far = 0), as the
            # shadow query's do: their parked origin is no dead mark
            return trace_fn(state.origin, state.direction, state.alive)

        def surface_of(state, b, hit):
            return surface_record(
                scene, cfg, rng.bounce_uniforms(state.keys, b, 8), hit.mat)

        if occl_fn is not None:
            def visible_of(x, wi_l, dist_l, worth):
                # dead lanes launch with t_far = 0 and cost nothing
                x_sh = torch.where(worth[..., None], x, PARK_ORIGIN)
                tf = torch.where(worth, dist_l * (1.0 - 1e-3), 0.0)
                with profiling.span("wave.occlusion"):
                    return ~occl_fn(x_sh.detach(), wi_l.detach(),
                                    tf.detach())
        else:
            def visible_of(x, wi_l, dist_l, worth):
                with profiling.span("wave.occlusion"):
                    sh = trace_fn(x, wi_l)
                return sh.t >= dist_l * (1.0 - 1e-3)
    else:
        def hit_of(state):
            return hit_from_params(rec["hp"], state.origin, state.direction,
                                   cfg.t_min)

        def surface_of(state, b, hit):
            return rec["surf"]

        def visible_of(x, wi_l, dist_l, worth):
            return rec["vis"] > 0.5

    # the forward route on the card shades each bounce without NEE in one
    # kernel launch (ops/wave_shade.py), bitwise ``shade_bounce``, which
    # the CPU, the replay, autograd and NEE keep
    tables = None
    if (replay is None and not do_nee
            and _kernels.takes_kernel(dev, "wavefront shading")
            and not wants_grad(scene, origin, direction)):
        tables = wave_shade.shade_tables(scene.materials, scene.sky)

    def bounce(state, bounce_idx):
        if profiling.enabled():
            profiling.count("wave.lanes", state.alive.shape[0])
            profiling.count("wave.live",
                            state.alive.sum(dtype=torch.float32))
        with profiling.span("wave.hit"):
            hit = hit_of(state)
        with profiling.span("wave.shade"):
            if tables is not None:
                return shade_kernel(state, bounce_idx, hit)
            return shade_bounce(scene, cfg, state, bounce_idx, hit,
                                surface_of(state, bounce_idx, hit),
                                visible_of)

    def shade_kernel(state, bounce_idx, hit):
        if profiling.enabled():
            profiling.count("wave.escaped", (state.alive & ~hit.valid).sum(
                dtype=torch.float32))
            profiling.count("wave.shade_kernel", state.alive.shape[0])
        u = rng.uniform_planes(state.keys, bounce_idx, 1, 8)
        # the first bounce reads the caller's rays; the later ones shade
        # the planes the kernel wrote in place
        out = wave_shade.shade_cuda(
            tables, cfg, bounce_idx, hit,
            (state.origin, state.direction, state.throughput,
             state.radiance, state.alive, state.prev_pdf), u,
            in_place=bounce_idx > 0)
        return PathState(*out, keys=state.keys)

    counts = []
    if replay is None:
        for b in range(cfg.max_bounces):
            state = bounce(state, b)
            counts.append(state.alive.sum(dtype=torch.float32))
        if collect_stats:
            return state.radiance, torch.stack(counts)
        return state.radiance

    # replay: a new segment starts at every tier bounce whose capacity is
    # below the current width; the records are monotone (hit ids, then -1
    # for good), so a ray can add radiance at bounces >= b only if it hit
    # at bounce b - 1
    B = cfg.max_bounces
    tiers = {int(b): int(d) for b, d in cfg.replay_tiers}
    starts = [0] + sorted(b for b, d in tiers.items()
                          if 0 < b < B and max(R // d, 1) < R)
    ids_all, vis_all = replay[0].detach(), replay[1].detach()
    rad_full = torch.zeros((R, 3), **f32)
    abs_idx = torch.arange(R, device=dev)
    tiered = False
    for b0, b1 in zip(starts, starts[1:] + [B]):
        if b0 > 0:
            S = max(R // tiers[b0], 1)
            if S < state.alive.shape[0]:
                mask = ids_all[b0 - 1][abs_idx] >= 0
                sel = torch.argsort((~mask).to(torch.int8), stable=True)[:S]
                rad_full = rad_full.index_add(0, abs_idx, state.radiance)
                state = PathState(
                    origin=state.origin[sel], direction=state.direction[sel],
                    throughput=state.throughput[sel],
                    radiance=torch.zeros((S, 3), **f32),
                    alive=state.alive[sel] & mask[sel],
                    prev_pdf=state.prev_pdf[sel], keys=state.keys[sel])
                abs_idx = abs_idx[sel]
                tiered = True
        if tiered:
            ids_seg, vis_seg = ids_all[b0:b1, abs_idx], vis_all[b0:b1, abs_idx]
        else:   # the identity subset: plain slices, no gather
            ids_seg, vis_seg = ids_all[b0:b1], vis_all[b0:b1]
        pre = _replay_tables(scene, cfg, ids_seg, vis_seg, state.keys, b0)
        for b in range(b0, b1):
            rec = _at(pre, b - b0)
            state = bounce(state, b)
            counts.append(state.alive.sum(dtype=torch.float32))
    radiance = state.radiance
    if tiered:
        radiance = rad_full.index_add(0, abs_idx, radiance)
    if collect_stats:
        return radiance, torch.stack(counts)
    return radiance
