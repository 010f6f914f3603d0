"""Three-lobe BSDF (counterpart of ``offline_raytracer_tpu/ops/bsdf.py``).

Lambert diffuse + GGX specular + rough dielectric transmission with Beer's
law attenuation, mixed by lobe weights proportional to ||Kd||, ||Ks||,
||Kt||. Batched and branch-free in the JAX functions' operation order, and
differentiable under autograd in (Kd, Ks, Kt, ior, roughness). N is the
geometric unit normal, wo points back toward the previous vertex, wi is
the continuation; wo.N >= 0 means wo is outside the surface.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.utils.math import frame_to_world, normalize

PI = float(np.pi)


@dataclasses.dataclass(frozen=True)
class MatParams:
    """Per-ray gathered material parameters (SoA)."""

    kd: torch.Tensor         # (R, 3)
    ks: torch.Tensor         # (R, 3)
    kt: torch.Tensor         # (R, 3)
    ior: torch.Tensor        # (R,)
    roughness: torch.Tensor  # (R,)


@dataclasses.dataclass(frozen=True)
class BsdfSample:
    wi: torch.Tensor               # (R, 3)
    is_transmission: torch.Tensor  # (R,) bool: the ray passes the surface


def _clip(x, lo, hi):
    """jnp.clip with its gradient at the bounds (half, where torch.clamp
    passes all of it)."""
    # 0-dim CPU tensors act as scalars on any device, with no copy
    lo, hi = (torch.tensor(v, dtype=x.dtype) for v in (lo, hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def lobe_weights(mat: MatParams):
    """Mixture probabilities pd, ps, pt proportional to ||Kd||, ||Ks||,
    ||Kt||."""
    ld = _length(mat.kd)
    ls = _length(mat.ks)
    lt = _length(mat.kt)
    s = torch.clamp(ld + ls + lt, min=1e-12)
    return ld / s, ls / s, lt / s


def schlick_fresnel(ks, cos_d):
    """F = Ks + (1 - Ks)(1 - |cos|)^5. ks: (R, 3), cos_d: (R,)."""
    m = torch.clamp(1.0 - torch.abs(cos_d), 0.0, 1.0)
    return ks + (1.0 - ks) * (m ** 5)[..., None]


def ggx_d(n_dot_h, roughness):
    """GGX normal distribution, tan^2 form."""
    a2 = roughness ** 2
    c = torch.clamp(n_dot_h, 1e-6, 1.0)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    denom = PI * c2 * c2 * (a2 + tan2) ** 2
    d = a2 / torch.clamp(denom, min=1e-20)
    return torch.where(n_dot_h > 0.0, d, 0.0)


def smith_g1(w, n, m, roughness):
    """Smith masking term for one direction."""
    w_dot_n = _dot(w, n)
    w_dot_m = _dot(w, m)
    same_side = (w_dot_n * w_dot_m) > 0.0
    c2 = torch.clamp(w_dot_n * w_dot_n, 1e-9, 1.0)
    tan2 = (1.0 - c2) / c2
    g = 2.0 / (1.0 + torch.sqrt(1.0 + roughness ** 2 * tan2))
    return torch.where(same_side, g, 0.0)


def _etas(n_dot_wo, ior):
    """(eta on wo's side, eta on the other side)."""
    outside = n_dot_wo >= 0.0
    return torch.where(outside, 1.0, ior), torch.where(outside, ior, 1.0)


def eval_bsdf(n, wi, wo, mat: MatParams, distance):
    """f(wi, wo) |wi.N|, cosine included. ``distance``: length of the
    segment arriving here, for Beer's law when it ran inside (wo.N < 0)."""
    n_dot_wi = _dot(wi, n)
    n_dot_wo = _dot(wo, n)
    same_side = (n_dot_wi * n_dot_wo) > 0.0

    ed = torch.where(same_side[..., None], mat.kd / PI, 0.0)

    h = torch.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = _dot(wi, h)
    f_spec = schlick_fresnel(mat.ks, wi_dot_h)
    d_spec = ggx_d(_dot(n, h), mat.roughness)
    g_spec = (smith_g1(wi, n, h, mat.roughness)
              * smith_g1(wo, n, h, mat.roughness))
    denom_s = 4.0 * torch.clamp(torch.abs(n_dot_wi) * torch.abs(n_dot_wo),
                                min=1e-6)
    es = f_spec * (d_spec * g_spec / denom_s)[..., None]
    h_faces_wi = wi_dot_h * torch.sign(n_dot_wi) > 0.0
    has_spec = (_dot(mat.ks, mat.ks) > 0.0) & h_faces_wi & same_side
    es = torch.where(has_spec[..., None], es, 0.0)

    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    ht = -(eta_wo[..., None] * wo + eta_wi[..., None] * wi)
    m = normalize(ht)
    m = m * torch.sign(_dot(m, n))[..., None]
    wo_dot_m = _dot(wo, m)
    wi_dot_m = _dot(wi, m)
    eta = eta_wo / eta_wi

    att = torch.where(
        (n_dot_wo < 0.0)[..., None],
        torch.exp(distance[..., None]
                  * torch.log(_clip(mat.kt, 1e-6, 1.0))),
        1.0)

    d_t = ggx_d(_dot(n, m), mat.roughness)
    g_t = (smith_g1(wi, n, m, mat.roughness)
           * smith_g1(wo, n, m, mat.roughness))
    f_t = 1.0 - schlick_fresnel(mat.ks, wi_dot_m)
    jac_denom = (eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2
    denom_t = torch.clamp(
        torch.abs(n_dot_wi) * torch.abs(n_dot_wo)
        * torch.clamp(jac_denom, min=1e-9), min=1e-9)
    num_t = (d_t * g_t * torch.abs(wi_dot_m) * torch.abs(wo_dot_m)
             * eta_wi ** 2)
    et_refract = torch.where((~same_side)[..., None],
                             f_t * (num_t / denom_t)[..., None], 0.0)
    # total internal reflection falls back to the specular lobe, classified
    # by the radicand at the reflection half vector h
    radicand_h = 1.0 - eta ** 2 * (1.0 - _dot(wo, h) ** 2)
    es_tir = f_spec * (d_spec * g_spec / denom_s)[..., None]
    tir_ok = same_side & (radicand_h < 0.0) & h_faces_wi
    es_tir = torch.where(tir_ok[..., None], es_tir, 0.0)
    et = torch.where(same_side[..., None], es_tir, et_refract)
    has_trans = _dot(mat.kt, mat.kt) > 0.0
    et = torch.where(has_trans[..., None], att * et, 0.0)

    return torch.abs(n_dot_wi)[..., None] * (ed + es + et)


def pdf_bsdf(n, wi, wo, mat: MatParams):
    """Mixture pdf of ``sample_bsdf`` in wi-space."""
    pd_c, ps_c, pt_c = lobe_weights(mat)
    n_dot_wi = _dot(wi, n)
    n_dot_wo = _dot(wo, n)

    pd = torch.clamp(n_dot_wi * torch.sign(n_dot_wo), min=0.0) / PI
    same_side = (n_dot_wi * n_dot_wo) > 0.0

    h = torch.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = _dot(wi, h)
    d_spec = ggx_d(_dot(n, h), mat.roughness)
    ps = d_spec * torch.abs(_dot(n, h)) / torch.clamp(
        4.0 * torch.abs(wi_dot_h), min=1e-9)
    ps = torch.where(same_side, ps, 0.0)

    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    m = normalize(-(eta_wo[..., None] * wo + eta_wi[..., None] * wi))
    m = m * torch.sign(_dot(m, n))[..., None]
    wo_dot_m = _dot(wo, m)
    wi_dot_m = _dot(wi, m)
    eta = eta_wo / eta_wi
    d_t = ggx_d(_dot(n, m), mat.roughness)
    jac_denom = torch.clamp((eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2,
                            min=1e-9)
    pt_refract = (d_t * torch.abs(_dot(n, m)) * eta_wi ** 2
                  * torch.abs(wi_dot_m) / jac_denom)
    pt_refract = torch.where(same_side, 0.0, pt_refract)
    radicand_h = 1.0 - eta ** 2 * (1.0 - _dot(wo, h) ** 2)
    pt = torch.where(same_side, torch.where(radicand_h < 0.0, ps, 0.0),
                     pt_refract)
    return pd_c * pd + ps_c * ps + pt_c * pt


def sample_bsdf(u, n, wo, mat: MatParams) -> BsdfSample:
    """Importance-sample wi from the 3-lobe mixture. ``u``: (..., 3)
    uniforms [e0, e1, lobe choice]."""
    pd_c, ps_c, _ = lobe_weights(mat)
    e0, e1, choice = u[..., 0], u[..., 1], u[..., 2]
    phi = 2.0 * PI * e1

    n_dot_wo = _dot(wo, n)
    n_face = n * torch.sign(n_dot_wo)[..., None]

    cos_d = torch.sqrt(e0)
    sin_d = torch.sqrt(torch.clamp(1.0 - e0, 0.0, 1.0))
    wi_diffuse = frame_to_world(torch.stack(
        [sin_d * torch.cos(phi), sin_d * torch.sin(phi), cos_d], -1), n_face)

    a2e = mat.roughness ** 2 * e0 / torch.clamp(1.0 - e0, min=1e-9)
    cos_m = 1.0 / torch.sqrt(1.0 + a2e)
    sin_m = torch.sqrt(torch.clamp(1.0 - cos_m ** 2, 0.0, 1.0))
    m = frame_to_world(torch.stack(
        [sin_m * torch.cos(phi), sin_m * torch.sin(phi), cos_m], -1), n_face)

    wo_dot_m = _dot(wo, m)
    wi_spec = 2.0 * torch.abs(wo_dot_m)[..., None] * m - wo

    # m faces wo, so the refracted direction lies beyond m: wi.m = -sq
    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    eta = eta_wo / eta_wi
    radicand = 1.0 - eta ** 2 * (1.0 - wo_dot_m ** 2)
    tir = radicand < 0.0
    sq = torch.sqrt(torch.clamp(radicand, 0.0, 1.0))
    wi_refract = (eta * wo_dot_m - sq)[..., None] * m - eta[..., None] * wo
    wi_trans = torch.where(tir[..., None], wi_spec, wi_refract)

    pick_d = choice < pd_c
    pick_s = (~pick_d) & (choice < pd_c + ps_c)
    wi = torch.where(pick_d[..., None], wi_diffuse,
                     torch.where(pick_s[..., None], wi_spec, wi_trans))
    is_trans = (~pick_d) & (~pick_s) & (~tir)
    return BsdfSample(wi=normalize(wi), is_transmission=is_trans)


def gather_mat_params(materials, mat_idx, default_roughness,
                      roughness_from_material=False) -> MatParams:
    """Per-ray material parameters from the material table. With
    ``roughness_from_material`` the Phong exponent maps to a GGX alpha,
    sqrt(2 / (exp + 2)); otherwise every material has the default."""
    i = mat_idx.long()
    # maximum, not clamp: at a tie (every default material has ior 1)
    # it passes half the gradient, as jnp.maximum does
    ior = materials.ior[i]
    ior = torch.maximum(ior, torch.ones_like(ior))
    if roughness_from_material:
        rough = torch.sqrt(2.0 / (materials.spec_exp[i] + 2.0))
    else:
        rough = torch.full_like(ior, default_roughness)
    return MatParams(kd=materials.diffuse[i], ks=materials.specular[i],
                     kt=materials.transmission[i], ior=ior, roughness=rough)
