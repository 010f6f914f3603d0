"""Area lights for NEE (counterpart of ``offline_raytracer_tpu/ops/lights.py``).

Every emissive shape is sampleable: spheres uniformly over their surface,
cylinders over lateral surface and caps by area, meshes (and emissive
boxes, registered as 12-triangle meshes) by an area-proportional triangle
pick from one globally monotone CDF. The light is picked uniformly.
``build_area_lights`` is numpy host code; ``sample_lights`` and the pdf
helpers (``light_pdf_area``, ``solid_angle_pdf``, ``mis_balance``) run in
torch on the device of their inputs, in the JAX functions' operation order
but for the cylinder's rotation, which sums in a fixed order of its own.
``sample_lights`` is the plain twin of ``csrc/light_sample.cu``
(``ops/light_sample.py``), which the segment route takes on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.scene.types import TensorTable

PI = float(np.pi)

KIND_SPHERE, KIND_CYLINDER, KIND_MESH = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class AreaLights(TensorTable):
    """SoA table of NEE-sampleable emissive shapes (L lights)."""

    kind: torch.Tensor      # (L,) int32
    mat: torch.Tensor       # (L,) int32
    area: torch.Tensor      # (L,)
    p0: torch.Tensor        # (L, 3) sphere center / cylinder base
    axis: torch.Tensor      # (L, 3) cylinder axis (|axis| = height)
    radius: torch.Tensor    # (L,)
    rot: torch.Tensor       # (L, 3, 3) cylinder world->local rotation
    tri_lo: torch.Tensor    # (L,) first row in the emissive-triangle pool
    tri_hi: torch.Tensor    # (L,) one past the last row
    cdf_base: torch.Tensor  # (L,) mesh ordinal offset into em_cdf
    em_v0: torch.Tensor     # (T, 3)
    em_v1: torch.Tensor
    em_v2: torch.Tensor
    em_cdf: torch.Tensor    # (T,) mesh light k's slice spans (k, k+1]

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass(frozen=True)
class LightSample:
    p: torch.Tensor         # (R, 3) point on the light
    normal: torch.Tensor    # (R, 3) outward surface normal
    emit: torch.Tensor      # (R, 3) emitted radiance
    pdf_area: torch.Tensor  # (R,) area pdf incl. the 1/L pick
    mat: torch.Tensor       # (R,) light material


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _rot_t(rot, v):
    """rot^T v per row, (R, 3, 3) and (R, 3) -> (R, 3): the products
    rounded, then summed in a fixed order, ((j=0 + j=1) + j=2), which
    csrc/light_sample.cuh repeats (an einsum is a batched gemv on the card,
    whose order no kernel can promise to copy)."""
    x = rot * v[:, :, None]
    return x[:, 0] + x[:, 1] + x[:, 2]


def sample_lights(u, lights: AreaLights, emit_table) -> LightSample:
    """(light, point) samples from uniforms ``u`` (R, 4): [pick, a, b, c]."""
    L = lights.count
    u_pick, u_a, u_b, u_c = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    idx = torch.clamp((u_pick * L).to(torch.int32), max=L - 1).long()

    kind = lights.kind[idx]
    r = lights.radius[idx]
    p0 = lights.p0[idx]
    axis = lights.axis[idx]
    rot = lights.rot[idx]

    # sphere: uniform on the surface
    z = 1.0 - 2.0 * u_a
    phi = 2.0 * PI * u_b
    s = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    n_sph = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], -1)
    p_sph = p0 + r[..., None] * n_sph

    # cylinder: lateral surface vs caps by area (local frame: base at the
    # origin, axis +z, height h; world = rot^T local + base)
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
        pick_lat[..., None],
        torch.stack([cphi, sphi, zeros], -1),
        torch.stack([zeros, zeros,
                     torch.where(pick_top, 1.0, -1.0).to(cphi.dtype)], -1))
    p_cyl = _rot_t(rot, p_local) + p0
    n_cyl = _rot_t(rot, n_local)

    # mesh: the light is chosen; the triangle comes from the globally
    # monotone CDF (light k's slice spans (k, k+1])
    if lights.em_cdf.shape[0] > 0:
        lo = lights.tri_lo[idx].long()
        hi = lights.tri_hi[idx].long()
        key = lights.cdf_base[idx] + torch.clamp(u_a, 1e-7, 1.0 - 1e-7)
        t_idx = torch.searchsorted(lights.em_cdf, key, right=False)
        t_idx = torch.minimum(torch.maximum(t_idx, lo),
                              torch.maximum(hi - 1, lo))
        tv0 = lights.em_v0[t_idx]
        tv1 = lights.em_v1[t_idx]
        tv2 = lights.em_v2[t_idx]
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
    pdf_area = 1.0 / (torch.clamp(lights.area[idx], min=1e-12) * L)
    mat = lights.mat[idx]
    return LightSample(p=p, normal=n, emit=emit_table[mat.long()],
                       pdf_area=pdf_area, mat=mat)


def light_pdf_area(lights: AreaLights, light_idx):
    """Area pdf of ``sample_lights`` for a light index (clipped)."""
    L = lights.count
    i = torch.clamp(light_idx.long(), 0, max(L - 1, 0))
    return 1.0 / (torch.clamp(lights.area[i], min=1e-12) * max(L, 1))


def solid_angle_pdf(pdf_area, dist, cos_light):
    """Area pdf -> solid-angle pdf at the shading point."""
    return pdf_area * dist ** 2 / torch.clamp(torch.abs(cos_light), min=1e-6)


def mis_balance(p_a, p_b):
    """Balance-heuristic weight of strategy a against b."""
    return p_a / torch.clamp(p_a + p_b, min=1e-12)


# ---------------------------------------------------------------------------
# Host-side construction (numpy)
# ---------------------------------------------------------------------------


def build_area_lights(entries) -> AreaLights:
    """entries: dicts {kind, mat, p0?, axis?, radius?, rot?, tris? (F,3,3)}
    -> AreaLights of CPU tensors."""
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
    em = []
    cdf_parts = []
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
            tris = np.asarray(e["tris"], np.float32)  # (F, 3, 3)
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
        ev0, ev1, ev2 = em_all[:, 0], em_all[:, 1], em_all[:, 2]
    else:
        ev0 = ev1 = ev2 = np.zeros((0, 3), np.float32)
        cdf_all = np.zeros((0,), np.float32)

    t = torch.from_numpy
    return AreaLights(
        kind=t(kind), mat=t(mat), area=t(area), p0=t(p0), axis=t(axis),
        radius=t(radius), rot=t(rot), tri_lo=t(tri_lo), tri_hi=t(tri_hi),
        cdf_base=t(cdf_base), em_v0=t(np.ascontiguousarray(ev0)),
        em_v1=t(np.ascontiguousarray(ev1)),
        em_v2=t(np.ascontiguousarray(ev2)), em_cdf=t(cdf_all))
