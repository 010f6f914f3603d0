"""Batched ray-primitive intersection (counterpart of
``offline_raytracer_tpu/ops/intersect.py``).

Branch-free functions that broadcast over a leading ray axis, in the JAX
functions' operation order: the all-pairs ``*_ts`` sweeps (rays x prims,
search only) and the per-winner ``*_hit_one`` recomputes, which stay
differentiable under autograd. A miss is t = +inf; normals are geometric
and normalised once, in ``refine_hit`` and ``hit_from_params``.

``sphere_sweep`` is the closest-sphere search of the wavefront route. It
follows the port's device rule (``ops/_kernels.takes_kernel``): CUDA
tensors take the kernel ``csrc/sphere_sweep.cu`` (one launch a query,
counted in ``KERNEL_LAUNCHES``; built with ``-fmad=false`` and IEEE
``sqrtf``, its sums in PyTorch's order on the card, so its distances are
the plain sweep's on the card bit for bit), which skips the lanes its
``alive`` mask marks dead and answers them as misses; CPU tensors take the
plain ``sphere_ts(...).min(-1)`` over every lane.

``hit_from_ids``, ``prefetch_hit_params`` and ``hit_from_params`` serve the
replay (path-replay backprop): they rebuild a hit, attached to the scene
tensors, from a winner id in the segment kernel's MegaMeta encoding.
"""

from __future__ import annotations

import dataclasses

import torch

from offline_raytracer_tpu_torch.ops import _kernels

INF = float("inf")

# launches of the sphere sweep kernel; chip runs read it to prove the
# wavefront's closest-hit queries went through the kernel
KERNEL_LAUNCHES = 0

# stable type ids for combining winners
SPHERE, BOX, CYLINDER, TRIANGLE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit record (SoA)."""

    t: torch.Tensor       # (R,) distance, +inf on a miss
    normal: torch.Tensor  # (R, 3) unit geometric normal
    mat: torch.Tensor     # (R,) int32 material (0 on a miss)
    inner: torch.Tensor   # (R,) bool: the ray started inside the primitive
    valid: torch.Tensor   # (R,) bool


def _sum3(x):
    return torch.sum(x, dim=-1)


def _norm(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


# ---------------------------------------------------------------------------
# sphere
# ---------------------------------------------------------------------------


def sphere_ts(sph, ro, rd, t_min):
    """All-pairs sphere hit distances. ro, rd: (R, 3) -> t: (R, N)."""
    rel = ro[:, None, :] - sph.center[None, :, :]
    b = _sum3(rd[:, None, :] * rel)
    c = _sum3(rel * rel) - sph.radius[None, :] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tn, tp = -b - sq, -b + sq
    t = torch.where(tn >= t_min, tn, tp)
    ok = (disc > 0.0) & (t >= t_min)
    return torch.where(ok, t, INF)


def sweep_inputs(sph, ro, rd, alive=None):
    """The kernel's operands, (center, radius, ro, rd, alive), contiguous
    (the camera's origins are one point expanded over the rays); raises
    ValueError on a device, dtype or shape the kernel does not take, an
    empty table, or sizes past its 32-bit indexing."""
    dev = ro.device
    R, N = ro.shape[0], sph.radius.shape[0]
    named = [("center", sph.center, (N, 3), torch.float32),
             ("radius", sph.radius, (N,), torch.float32),
             ("ro", ro, (R, 3), torch.float32),
             ("rd", rd, (R, 3), torch.float32)]
    if alive is not None:
        named.append(("alive", alive, (R,), torch.bool))
    for name, x, shape, dtype in named:
        if x.device != dev:
            raise ValueError(f"sphere sweep: {name} is on {x.device}, the "
                             f"rays on {dev}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"sphere sweep: {name} must be {shape} {dtype}, "
                             f"got {tuple(x.shape)} {x.dtype}")
    if N == 0:
        raise ValueError("sphere sweep: the sphere table is empty")
    if 3 * max(R, N) >= 2 ** 31:
        raise ValueError(f"sphere sweep: {R} rays or {N} spheres are past "
                         f"the kernel's 32-bit indexing")
    out = [x.contiguous() for _, x, _, _ in named]
    return tuple(out) + ((None,) if alive is None else ())


def sphere_sweep_cuda(sph, ro, rd, t_min, alive=None):
    """``sphere_sweep`` in one kernel launch (``csrc/sphere_sweep.cu``), on
    CUDA tensors; a lane whose ``alive`` is False is a miss, untested."""
    global KERNEL_LAUNCHES
    if ro.device.type != "cuda":
        raise ValueError(f"sphere_sweep_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    center, radius, ro, rd, alive = sweep_inputs(sph, ro, rd, alive)
    R = ro.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=ro.device)
    idx = torch.empty((R,), dtype=torch.int32, device=ro.device)
    if R == 0:
        return t, idx
    _kernels.launch("sphere_sweep", ro.device, ro.data_ptr(), rd.data_ptr(),
                    center.data_ptr(), radius.data_ptr(),
                    None if alive is None else alive.data_ptr(),
                    t.data_ptr(), idx.data_ptr(), R, radius.shape[0],
                    float(t_min))
    KERNEL_LAUNCHES += 1
    return t, idx


def sphere_sweep(sph, ro, rd, t_min, alive=None):
    """The closest sphere of each ray: (t (R,) float32, +inf on a miss;
    index (R,) int32, the first of equals, 0 on a miss), as
    ``sphere_ts(...).min(-1)``. CUDA rays take the kernel, which answers a
    lane whose ``alive`` is False as a miss without testing it; CPU rays
    take the plain sweep over every lane (``alive`` unread)."""
    if _kernels.takes_kernel(ro.device, "sphere sweep"):
        return sphere_sweep_cuda(sph, ro, rd, t_min, alive)
    t, idx = sphere_ts(sph, ro, rd, t_min).min(-1)
    return t, idx.to(torch.int32)


def sphere_hit_one(center, radius, ro, rd, t_min):
    """Differentiable single-sphere hit: center (R, 3), radius (R,)."""
    rel = ro - center
    b = _sum3(rd * rel)
    c = _sum3(rel * rel) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    tn, tp = -b - sq, -b + sq
    inner = tn < t_min
    t = torch.where(inner, tp, tn)
    normal = rel + t[..., None] * rd
    return t, normal, inner


# ---------------------------------------------------------------------------
# axis-aligned box: entry hit if t_entry >= t_min, else the exit hit
# ---------------------------------------------------------------------------


def box_ts(box, ro, rd, t_min):
    """All-pairs box hit distances. -> (R, N)."""
    inv = 1.0 / rd
    t0 = (box.bmin[None] - ro[:, None, :]) * inv[:, None, :]
    t1 = (box.bmax[None] - ro[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    t = torch.where(tmin >= t_min, tmin, tmax)
    ok = tmax >= torch.clamp(tmin, min=t_min)
    return torch.where(ok, t, INF)


def box_hit_one(bmin, bmax, ro, rd, t_min):
    """Differentiable single-box hit: bmin, bmax (R, 3)."""
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
    normal = n_axis * torch.where(inner, sgn, -sgn)[..., None]
    return t, normal, inner


# ---------------------------------------------------------------------------
# cylinder: slab (two caps) and infinite cylinder in the local frame
# ---------------------------------------------------------------------------


def cylinder_ts(cyl, ro, rd, t_min):
    """All-pairs cylinder hit distances. -> (R, N)."""
    rel = ro[:, None, :] - cyl.base[None]
    o = torch.einsum("nij,rnj->rni", cyl.rot, rel)
    d = torch.einsum("nij,rj->rni", cyl.rot, rd)
    height = _norm(cyl.axis)[None]

    t_bot = -o[..., 2] / d[..., 2]
    t_top = (height - o[..., 2]) / d[..., 2]
    t_slab_min = torch.minimum(t_bot, t_top)
    t_slab_max = torch.maximum(t_bot, t_top)

    a = _sum3(d[..., :2] ** 2)
    b = _sum3(d[..., :2] * o[..., :2])
    c = _sum3(o[..., :2] ** 2) - cyl.radius[None] ** 2
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_ok = a > 1e-12
    safe_a = torch.where(a_ok, a, 1.0)
    t_cyl_min = torch.where(a_ok, (-b - sq) / safe_a, -INF)
    t_cyl_max = torch.where(a_ok, (-b + sq) / safe_a, INF)

    t_entry = torch.maximum(t_slab_min, t_cyl_min)
    t_exit = torch.minimum(t_slab_max, t_cyl_max)
    t = torch.where(t_entry >= t_min, t_entry, t_exit)
    ok = (disc >= 0.0) & (t_exit >= torch.clamp(t_entry, min=t_min))
    return torch.where(ok, t, INF)


def cylinder_hit_one(base, axis, radius, rot, ro, rd, t_min):
    """Differentiable single-cylinder hit. rot: (R, 3, 3) world->local."""
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
    normal = torch.einsum("rji,rj->ri", rot, n_local)
    return t, normal, inner


# ---------------------------------------------------------------------------
# triangle: Moller-Trumbore
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def triangle_ts(tri, ro, rd, t_min):
    """All-pairs triangle hit distances. -> (R, N)."""
    e1 = tri.v1 - tri.v0
    e2 = tri.v2 - tri.v0
    pvec = _cross(rd[:, None, :].expand(-1, e2.shape[0], -1),
                  e2[None].expand(rd.shape[0], -1, -1))
    det = _sum3(pvec * e1[None])
    tvec = ro[:, None, :] - tri.v0[None]
    qvec = _cross(tvec, e1[None].expand_as(tvec))
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    u = _sum3(pvec * tvec) * inv_det
    v = _sum3(qvec * rd[:, None, :]) * inv_det
    t = _sum3(qvec * e2[None]) * inv_det
    ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
    return torch.where(ok, t, INF)


def triangle_hit_one(v0, v1, v2, ro, rd, t_min):
    """Differentiable single-triangle hit: v0/v1/v2 (R, 3)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(rd, e2)
    det = _sum3(pvec * e1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    tvec = ro - v0
    qvec = _cross(tvec, e1)
    t = _sum3(qvec * e2) * inv_det
    normal = _cross(e1, e2)
    inner = torch.zeros_like(t, dtype=torch.bool)
    return t, normal, inner


# ---------------------------------------------------------------------------
# closest hit over the whole scene
# ---------------------------------------------------------------------------


class Closest:
    """Running (t, type, index) winner over all-pairs sweeps."""

    def __init__(self, R, device):
        self.t = torch.full((R,), INF, dtype=torch.float32, device=device)
        self.type = torch.zeros((R,), dtype=torch.int32, device=device)
        self.idx = torch.zeros((R,), dtype=torch.int32, device=device)

    def consider(self, t_all, type_id):
        self.consider_min(*t_all.min(-1), type_id)

    def consider_min(self, t_prim, i_prim, type_id):
        """Take each ray's best of one table, (t, index) (R,), where it is
        nearer than the winner so far."""
        better = t_prim < self.t
        self.t = torch.where(better, t_prim, self.t)
        self.type = torch.where(better, type_id, self.type).to(torch.int32)
        self.idx = torch.where(better, i_prim.to(torch.int32), self.idx)

    def consider_analytic(self, scene, ro, rd, t_min, alive=None):
        """Every analytic table: the spheres by ``sphere_sweep`` (``alive``:
        the lanes whose hit is wanted, read by the kernel), boxes and
        cylinders by their dense sweeps."""
        if scene.spheres.radius.shape[0]:
            self.consider_min(*sphere_sweep(scene.spheres, ro, rd, t_min,
                                            alive), SPHERE)
        if scene.boxes.mat.shape[0]:
            self.consider(box_ts(scene.boxes, ro, rd, t_min), BOX)
        if scene.cylinders.radius.shape[0]:
            self.consider(cylinder_ts(scene.cylinders, ro, rd, t_min),
                          CYLINDER)


def closest_hit_bruteforce(scene, ro, rd, t_min,
                           include_triangles: bool = True,
                           alive=None) -> Hit:
    """The closest hit over every primitive table, no BVH. ro, rd: (R, 3);
    ``alive`` (R,) bool: the lanes whose hit is wanted (the sphere kernel
    answers the others as misses; ``Closest.consider_analytic``)."""
    with torch.no_grad():
        best = Closest(ro.shape[0], ro.device)
        best.consider_analytic(scene, ro, rd, t_min, alive)
        if include_triangles and scene.triangles.mat.shape[0]:
            best.consider(triangle_ts(scene.triangles, ro, rd, t_min),
                          TRIANGLE)
    return refine_hit(scene, ro, rd, t_min, best.type, best.idx,
                      best.t < INF)


def _decode_ids(scene, ids):
    """MegaMeta hit ids -> (valid, clamped id, primitive type, index within
    the analytic table; 0 for triangles)."""
    ns = scene.spheres.radius.shape[0]
    nb = scene.boxes.mat.shape[0]
    nc = scene.cylinders.radius.shape[0]
    valid = ids >= 0
    i = torch.clamp(ids, min=0)
    prim_type = torch.where(
        i < ns, SPHERE,
        torch.where(i < ns + nb, BOX,
                    torch.where(i < ns + nb + nc, CYLINDER, TRIANGLE)))
    prim_idx = torch.where(
        i < ns, i,
        torch.where(i < ns + nb, i - ns,
                    torch.where(i < ns + nb + nc, i - ns - nb, 0)))
    return valid, i, prim_type, prim_idx


def _tri_rows(scene, i):
    """Original triangle rows of the BVH slots that ids ``i`` name."""
    tri_index = scene.tri_bvh.tri_index
    base = (scene.spheres.radius.shape[0] + scene.boxes.mat.shape[0]
            + scene.cylinders.radius.shape[0])
    slot = torch.clamp(i - base, 0, tri_index.shape[0] - 1)
    return torch.clamp(tri_index[slot.long()], min=0)


def hit_from_ids(scene, ro, rd, ids, t_min) -> Hit:
    """Hit record from the segment kernel's winner ids, attached to the
    scene tensors (replay path).

    ``ids`` (R,) int32 in the MegaMeta encoding (ops/mega.py): -1 miss,
    [0, ns) sphere, [ns, ns+nb) box, [.., +nc) cylinder, then BVH triangle
    slots (leaf * 128 + lane), mapped to triangle rows through
    ``scene.tri_bvh.tri_index``. No search: only the known winner's (t,
    normal, mat) are recomputed, so d(image)/d(geometry) flows.
    """
    valid, i, prim_type, prim_idx = _decode_ids(scene, ids)
    if scene.triangles.mat.shape[0] and scene.tri_bvh is not None:
        prim_idx = torch.where(prim_type == TRIANGLE,
                               _tri_rows(scene, i).to(prim_idx.dtype),
                               prim_idx)
    return refine_hit(scene, ro, rd, t_min, prim_type, prim_idx, valid)


def prefetch_hit_params(scene, ids) -> dict:
    """Every id-dependent gather of the replay, done once for all bounces.

    ``ids``: MegaMeta-encoded int32 of any shape. Each returned tensor has
    the ids' shape in front and stays attached to the scene tensors, so the
    parameter gradients enter through these gathers (scatter-adds in the
    backward). A miss gets material 0; indices are clamped into each table.
    """
    ns = scene.spheres.radius.shape[0]
    nb = scene.boxes.mat.shape[0]
    nc = scene.cylinders.radius.shape[0]
    valid, i, prim_type, prim_idx = _decode_ids(scene, ids)
    hp = {"valid": valid, "prim_type": prim_type,
          "mat": torch.zeros_like(i)}

    def msel(type_id, m_i):
        hp["mat"] = torch.where(valid & (prim_type == type_id),
                                m_i.to(i.dtype), hp["mat"])

    sph, box, cyl, tri = (scene.spheres, scene.boxes, scene.cylinders,
                          scene.triangles)
    if ns:
        si = torch.clamp(prim_idx, 0, ns - 1).long()
        hp["sph_c"] = sph.center[si]
        hp["sph_r"] = sph.radius[si]
        msel(SPHERE, sph.mat[si])
    if nb:
        bi = torch.clamp(prim_idx, 0, nb - 1).long()
        hp["box_lo"] = box.bmin[bi]
        hp["box_hi"] = box.bmax[bi]
        msel(BOX, box.mat[bi])
    if nc:
        ci = torch.clamp(prim_idx, 0, nc - 1).long()
        hp["cyl_b"] = cyl.base[ci]
        hp["cyl_a"] = cyl.axis[ci]
        hp["cyl_r"] = cyl.radius[ci]
        hp["cyl_rot"] = cyl.rot[ci]
        msel(CYLINDER, cyl.mat[ci])
    if tri.mat.shape[0] and scene.tri_bvh is not None:
        ti = _tri_rows(scene, i).long()
        hp["tri_v0"] = tri.v0[ti]
        hp["tri_v1"] = tri.v1[ti]
        hp["tri_v2"] = tri.v2[ti]
        msel(TRIANGLE, tri.mat[ti])
    return hp


def hit_from_params(hp, ro, rd, t_min) -> Hit:
    """Gather-free hit recompute from ``prefetch_hit_params`` output sliced
    to one bounce: the same results as ``hit_from_ids``."""
    R = ro.shape[0]
    dev = ro.device
    t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    normal = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    inner = torch.zeros((R,), dtype=torch.bool, device=dev)
    valid = hp["valid"]
    prim_type = hp["prim_type"]

    def blend(type_id, t_i, n_i, inner_i):
        nonlocal t, normal, inner
        sel = valid & (prim_type == type_id)
        t = torch.where(sel, t_i, t)
        normal = torch.where(sel[..., None], n_i, normal)
        inner = torch.where(sel, inner_i, inner)

    if "sph_c" in hp:
        blend(SPHERE, *sphere_hit_one(hp["sph_c"], hp["sph_r"], ro, rd,
                                      t_min))
    if "box_lo" in hp:
        blend(BOX, *box_hit_one(hp["box_lo"], hp["box_hi"], ro, rd, t_min))
    if "cyl_b" in hp:
        blend(CYLINDER, *cylinder_hit_one(
            hp["cyl_b"], hp["cyl_a"], hp["cyl_r"], hp["cyl_rot"], ro, rd,
            t_min))
    if "tri_v0" in hp:
        blend(TRIANGLE, *triangle_hit_one(
            hp["tri_v0"], hp["tri_v1"], hp["tri_v2"], ro, rd, t_min))

    normal = normal / torch.clamp(_norm(normal, keepdim=True), min=1e-12)
    return Hit(t=t, normal=normal, mat=hp["mat"], inner=inner & valid,
               valid=valid)


def refine_hit(scene, ro, rd, t_min, prim_type, prim_idx, valid) -> Hit:
    """Differentiable recompute of (t, normal, mat) for known winners: the
    search only picks integer winners, gradients flow through this."""
    R = ro.shape[0]
    dev = ro.device
    t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    normal = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    mat = torch.zeros((R,), dtype=torch.int32, device=dev)
    inner = torch.zeros((R,), dtype=torch.bool, device=dev)

    def blend(type_id, t_i, n_i, inner_i, mat_i):
        nonlocal t, normal, mat, inner
        sel = valid & (prim_type == type_id)
        t = torch.where(sel, t_i, t)
        normal = torch.where(sel[..., None], n_i, normal)
        mat = torch.where(sel, mat_i, mat)
        inner = torch.where(sel, inner_i, inner)

    idx = prim_idx.long()
    sph, box, cyl, tri = (scene.spheres, scene.boxes, scene.cylinders,
                          scene.triangles)
    if sph.radius.shape[0]:
        i = torch.clamp(idx, 0, sph.radius.shape[0] - 1)
        blend(SPHERE, *sphere_hit_one(sph.center[i], sph.radius[i], ro, rd,
                                      t_min), sph.mat[i])
    if box.mat.shape[0]:
        i = torch.clamp(idx, 0, box.mat.shape[0] - 1)
        blend(BOX, *box_hit_one(box.bmin[i], box.bmax[i], ro, rd, t_min),
              box.mat[i])
    if cyl.radius.shape[0]:
        i = torch.clamp(idx, 0, cyl.radius.shape[0] - 1)
        blend(CYLINDER, *cylinder_hit_one(
            cyl.base[i], cyl.axis[i], cyl.radius[i], cyl.rot[i], ro, rd,
            t_min), cyl.mat[i])
    if tri.mat.shape[0]:
        i = torch.clamp(idx, 0, tri.mat.shape[0] - 1)
        blend(TRIANGLE, *triangle_hit_one(tri.v0[i], tri.v1[i], tri.v2[i],
                                          ro, rd, t_min), tri.mat[i])

    normal = normal / torch.clamp(_norm(normal, keepdim=True), min=1e-12)
    return Hit(t=t, normal=normal, mat=torch.where(valid, mat, 0),
               inner=inner & valid, valid=valid)
