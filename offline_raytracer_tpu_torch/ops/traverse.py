"""Triangle traversal of the wavefront route (counterpart of
``offline_raytracer_tpu/ops/traverse.py``).

A triangle query has one contract, whichever implementation answers it:
``(ro, rd, t_min, t_far, any_hit) -> (t (R,), slot (R,) int32)``. ``slot``
indexes the leaf-ordered arrays (``bvh.tri_index``, ``bvh.mat``), -1 is a
miss and t is +inf there. The winner is the least (t, slot) among hits with
``t_min <= t < t_far``; that rule does not depend on visit order, so every
implementation gives the same answer. In any-hit mode only ``slot >= 0``
counts (t is ``t_min`` on a hit). A ray is dead, and misses, when its
``t_far <= t_min``: that bound is the only dead mark, so the integrator
launches its finished paths with ``t_far = 0`` in both queries, and a live
ray may start however far out (as in the JAX package's queries).

Three implementations:

- ``tri_hit_plain`` here: a chunked dense sweep over every occupied slot,
  the plain version both kernels are held against. It is the true closest
  hit, so it also catches a cull that drops a leaf. It stands in for the
  JAX package's jnp packet walk (``traverse.bvh_hit_ts``), which agrees
  with it up to exact ties; an eager node-by-node walk would wait on the
  host at every node.
- ``traverse_cull.bvh_hit_ts_cull``: the cull-and-sweep kernel
  (``csrc/traverse_cull.cu``): each row of rays culls the leaf boxes and
  sweeps the leaves it listed.
- ``traverse_packet.bvh_hit_ts_packet``: the tree walk kernel
  (``csrc/traverse_packet.cu``).

Both kernels carry each ray with a group of G lanes (``group_size`` picks G
from the number of rays) and sweep a leaf through its 16 sub-boxes
(``csrc/leaf_sweep.cuh``); any G gives the same outputs.

Traversal is search only: rays and bounds are detached, and the hit that
shading uses (and differentiates) is recomputed by ``intersect.refine_hit``.

While the recorder of ``utils/profiling.py`` is on, the integrator's
triangle queries (``make_bvh_trace_fn``, ``make_bvh_occlusion_fn``) are
spans ``traverse.closest`` and ``traverse.any`` (each the query with its
coherence sort, scatter and counts) and count ``traverse.rays`` (lanes handed to
the query), ``traverse.live`` (those live in it: t_far > t_min) and
``traverse.hits`` (those it answered with a hit), over both kinds.
"""

from __future__ import annotations

import dataclasses

import torch

from offline_raytracer_tpu_torch.ops import _kernels
from offline_raytracer_tpu_torch.ops import intersect as I
from offline_raytracer_tpu_torch.ops.bvh import LEAF
from offline_raytracer_tpu_torch.utils import profiling

INF = float("inf")
GROUPS = (1, 2, 4, 8, 16, 32)   # lanes per ray the kernels are built for
# the lanes-per-ray rule of both kernels (group_size): aim a query's rays
# at GROUP_LANES lanes, at most GROUP_MAX per ray (tuned on the H100,
# PERF.md)
GROUP_LANES = 1 << 22
GROUP_MAX = 16
_BIG = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class TriTables:
    """The packed LBVH in the layout the queries read, built once per
    scene (``tri_tables``)."""

    tri: torch.Tensor          # (S, 12) float32 coefficient row per slot
    tri_lm: torch.Tensor       # (S / 128, 3, 128, 4) leaf-major copy (kernels)
    sub: torch.Tensor | None   # (S / 128, SUB, 8) sub-leaf boxes (kernels)
    nodes: torch.Tensor        # (n_internal, 12) child AABBs per heap node
    leaf_bounds: torch.Tensor  # (6, L_lane) leaf AABB rows
    tri_index: torch.Tensor    # (S,) int32 original triangle id, -1 pad
    n_leaves: int              # leaves of the implicit heap (power of 2)
    m_occ: int                 # occupied leaves


def leaf_major(tri):
    """(S, 12) coefficient rows -> the kernels' leaf-major (S / 128, 3, 128,
    4) copy: per leaf 128 float4 [n cw], then 128 [s1 c1], then 128 [s2
    c2], so that consecutive lanes read consecutive slots' float4."""
    return (tri.reshape(-1, LEAF, 3, 4)[:, :, [2, 0, 1]]
            .permute(0, 2, 1, 3).contiguous())


def tri_tables(bvh) -> TriTables:
    """The query tables of a TriBVH; ``sub`` is None for a BVH without
    sub-boxes (the kernels refuse it, the plain sweep does not need it)."""
    m_pad = bvh.planes.shape[1]
    tri = bvh.planes.permute(1, 2, 0).reshape(m_pad * LEAF, 12).contiguous()
    sub = (None if bvh.sub_bounds is None else torch.nn.functional.pad(
        bvh.sub_bounds, (0, 2)).contiguous())
    return TriTables(
        tri=tri, tri_lm=leaf_major(tri), sub=sub,
        nodes=bvh.child_rows[:, :12].contiguous(),
        leaf_bounds=bvh.leaf_bounds.contiguous(), tri_index=bvh.tri_index,
        n_leaves=bvh.n_leaves, m_occ=bvh.m_occ)


def live_rays(ro, t_far, t_min):
    """(R,) bool: the rays a query asks anything of (the contract's live
    rays: t_far > t_min; all of them without a bound)."""
    if t_far is None:
        return torch.ones(ro.shape[:1], dtype=torch.bool, device=ro.device)
    return t_far > t_min


def group_size(n_rays: int) -> int:
    """Lanes per ray for a query of ``n_rays`` rays: a power of two,
    enough that the rays fill GROUP_LANES lanes, at most GROUP_MAX (a
    leaf's work, 16 sub-box tests and then 8 triangles per box hit, fills
    no more lanes). Dead rays cost little, so the rays are not counted
    alive: a count costs a sync per query, more than a G fitted to the live
    rays gains (PERF.md). Any choice gives the same outputs."""
    g = 1
    while g < GROUP_MAX and max(n_rays, 1) * g * 2 <= GROUP_LANES:
        g *= 2
    return g


def tri_hit_plain(tables: TriTables, ro, rd, t_min, t_far=None,
                  any_hit: bool = False):
    """Dense sweep over all occupied slots, in chunks of slots: the plain
    version of both traversal kernels, same contract."""
    R = ro.shape[0]
    dev = ro.device
    S = tables.m_occ * LEAF
    # a dead ray (t_far <= t_min) passes no hit's t_min <= t < t_far
    bound = (torch.full((R,), INF, dtype=torch.float32, device=dev)
             if t_far is None else t_far)
    chunk = max(LEAF, min(S, ((1 << 24) // max(R, 1)) // LEAF * LEAF))
    best = torch.full((R,), _BIG, dtype=torch.int64, device=dev)
    ox, oy, oz = (ro[:, k:k + 1] for k in range(3))
    dx, dy, dz = (rd[:, k:k + 1] for k in range(3))
    bnd = bound[:, None]
    for s0 in range(0, S, chunk):
        cf = tables.tri[s0:min(S, s0 + chunk)].T
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
        slot = torch.arange(s0, s0 + cf.shape[1], dtype=torch.int64,
                            device=dev)[None, :]
        if any_hit:
            key = torch.where(ok, slot, _BIG)
        else:
            # t >= t_min > 0, so its bit pattern orders like its value
            enc = t.contiguous().view(torch.int32).to(torch.int64)
            key = torch.where(ok, (enc << 32) | slot, _BIG)
        best = torch.minimum(best, key.min(dim=1).values)
    hit = best < _BIG
    slot = torch.where(hit, best & 0xFFFFFFFF, -1).to(torch.int32)
    if any_hit:
        t = torch.where(hit, float(t_min), INF)
    else:
        t = torch.where(
            hit, (best >> 32).to(torch.int32).view(torch.float32), INF)
    return t, slot


def check_query(tables: TriTables, ro, rd, t_far, device_type):
    """Device, dtype, shape and contiguity checks of a kernel query."""
    from offline_raytracer_tpu_torch.ops.bvh import SUB

    R = ro.shape[0]
    if ro.device.type != device_type:
        raise ValueError(f"needs {device_type} tensors, got {ro.device}")
    if tables.sub is None:
        raise ValueError("the tables have no sub-boxes: build the BVH with "
                         "ops/bvh.build_tri_bvh or convert.scene_from_arrays")
    n_leaf_rows = tables.tri.shape[0] // LEAF
    items = [("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
             ("tri", tables.tri, (n_leaf_rows * LEAF, 12)),
             ("tri_lm", tables.tri_lm, (n_leaf_rows, 3, LEAF, 4)),
             ("sub", tables.sub, (n_leaf_rows, SUB, 8)),
             ("nodes", tables.nodes, (tables.nodes.shape[0], 12)),
             ("leaf_bounds", tables.leaf_bounds,
              (6, tables.leaf_bounds.shape[1]))]
    if t_far is not None:
        items.append(("t_far", t_far, (R,)))
    for name, x, shape in items:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, want float32")
        if x.device != ro.device:
            raise ValueError(f"{name} on {x.device}, rays on {ro.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if tables.m_occ > n_leaf_rows:
        raise ValueError("tri holds fewer slots than m_occ leaves")
    if not 1 <= tables.n_leaves < 1 << 31:
        raise ValueError(f"n_leaves {tables.n_leaves} outside [1, 2**31)")


def launch_query(name: str, ro, rd, t_min, t_far, any_hit: bool,
                 group: int, table_ptrs, ints):
    """Launch traversal kernel ``name`` (``csrc/<name>.cu``) on the current
    stream, no sync. Both C entry points take (ro, rd, t_far or null, three
    table pointers, t out, slot out, R, two ints, any_hit, group, t_min,
    stream). -> (t (R,), slot (R,)): t is inf on a miss and t_min on an
    any hit, slot -1 on a miss."""
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    R = ro.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=ro.device)
    slot = torch.empty((R,), dtype=torch.int32, device=ro.device)
    _kernels.launch(name, ro.device, ro.data_ptr(), rd.data_ptr(),
                    None if t_far is None else t_far.data_ptr(),
                    *table_ptrs, t.data_ptr(), slot.data_ptr(), R, *ints,
                    int(any_hit), group, float(t_min))
    return t, slot


def coherence_order(tables: TriTables, ro, rd):
    """Sort permutation grouping rays by direction octant, then by a
    3-bit-per-axis Morton cell of the origin within the scene box."""
    row = tables.nodes[0]
    wmin = torch.minimum(row[0:3], row[6:9])
    wmax = torch.maximum(row[3:6], row[9:12])
    ext = torch.clamp(wmax - wmin, min=1e-6)
    q = torch.clamp((ro - wmin) / ext * 8.0, 0.0, 7.0).to(torch.int32)

    def spread3(x):
        return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)

    morton = ((spread3(q[:, 0]) << 2) | (spread3(q[:, 1]) << 1)
              | spread3(q[:, 2]))
    octant = (((rd[:, 0] > 0).to(torch.int32) << 2)
              | ((rd[:, 1] > 0).to(torch.int32) << 1)
              | (rd[:, 2] > 0).to(torch.int32))
    return torch.argsort((octant << 9) | morton, stable=True)


def pick_tri_hit(tables: TriTables, cfg):
    """The triangle query for ``cfg``:

    - ``use_pallas`` off, or ``traversal="jnp"``: the plain dense sweep,
      on every device;
    - ``traversal`` "auto", "mega" or "cull": the cull-and-sweep kernel
      when the tree qualifies (``traverse_cull.cull_ok``, at most 4096
      leaves), else the packet walk kernel;
    - ``traversal="packet"``: the packet walk kernel.

    "mega" reaches here only for a scene the segment kernel cannot host.
    The kernels' wrappers take the kernel for CUDA tensors and the plain
    version for CPU tensors.
    """
    if not cfg.use_pallas or cfg.traversal == "jnp":
        return tri_hit_plain
    from offline_raytracer_tpu_torch.ops import traverse_cull, traverse_packet

    if cfg.traversal != "packet" and traverse_cull.cull_ok(tables):
        return traverse_cull.bvh_hit_ts_cull
    return traverse_packet.bvh_hit_ts_packet


def sorted_tri_hit(tables, tri_hit, cfg, ro, rd, t_far=None,
                   any_hit=False):
    """One triangle query, search only, on coherence-sorted rays when
    ``cfg.sort_rays``; results come back in the callers' ray order."""
    ro, rd = ro.detach(), rd.detach()
    t_far = None if t_far is None else t_far.detach()
    if not cfg.sort_rays:
        return tri_hit(tables, ro, rd, cfg.t_min, t_far, any_hit=any_hit)
    order = coherence_order(tables, ro, rd)
    tf = None if t_far is None else t_far[order].contiguous()
    t_s, slot_s = tri_hit(tables, ro[order].contiguous(),
                          rd[order].contiguous(), cfg.t_min, tf,
                          any_hit=any_hit)
    t = torch.empty_like(t_s)
    slot = torch.empty_like(slot_s)
    t[order] = t_s
    slot[order] = slot_s
    return t, slot


def count_query(ro, t_far, t_min, slot):
    """A triangle query's lanes, live lanes and hits to the recorder's
    counters ``traverse.rays``, ``traverse.live`` and ``traverse.hits``
    (nothing while it is off; no count waits for the device)."""
    if profiling.enabled():
        profiling.count("traverse.rays", ro.shape[0])
        profiling.count("traverse.live", live_rays(ro, t_far, t_min).sum(
            dtype=torch.float32))
        profiling.count("traverse.hits", (slot >= 0).sum(
            dtype=torch.float32))


def make_bvh_trace_fn(scene, cfg, tables: TriTables | None = None):
    """Closest-hit function (ro, rd, alive=None) -> Hit: dense sweeps for
    the analytic primitives, the BVH query for triangles, one
    differentiable ``refine_hit`` of the winner. ``alive`` (R,) bool: the
    lanes whose hit is wanted; the others go to the triangle query with
    ``t_far = 0`` (dead) and to the sphere kernel as misses, and cost them
    nothing."""
    bvh = scene.tri_bvh
    if bvh is None:
        raise ValueError("scene has no tri_bvh; build it with with_bvh=True")
    tables = tri_tables(bvh) if tables is None else tables
    tri_hit = pick_tri_hit(tables, cfg)

    def trace(ro, rd, alive=None):
        with torch.no_grad():
            best = I.Closest(ro.shape[0], ro.device)
            best.consider_analytic(scene, ro, rd, cfg.t_min, alive)
            tf = None if alive is None else torch.where(alive, INF, 0.0)
            with profiling.span("traverse.closest"):
                tt, slot = sorted_tri_hit(tables, tri_hit, cfg, ro, rd, tf)
                count_query(ro, tf, cfg.t_min, slot)
            tri_id = torch.where(
                slot >= 0, tables.tri_index[torch.clamp(slot, min=0).long()],
                -1)
            better = (tt < best.t) & (tri_id >= 0)
            best.t = torch.where(better, tt, best.t)
            best.type = torch.where(better, I.TRIANGLE, best.type).to(
                torch.int32)
            best.idx = torch.where(better, tri_id, best.idx)
        return I.refine_hit(scene, ro, rd, cfg.t_min, best.type, best.idx,
                            best.t < INF)

    return trace


def analytic_occluded(scene, ro, rd, t_far, t_min):
    """(R,) bool: a sphere, box or cylinder in [t_min, t_far)? Dense
    sweeps over each table."""
    hit = torch.zeros(ro.shape[:1], dtype=torch.bool, device=ro.device)
    tf = t_far[:, None]
    if scene.spheres.radius.shape[0]:
        hit |= (I.sphere_ts(scene.spheres, ro, rd, t_min) < tf).any(-1)
    if scene.boxes.mat.shape[0]:
        hit |= (I.box_ts(scene.boxes, ro, rd, t_min) < tf).any(-1)
    if scene.cylinders.radius.shape[0]:
        hit |= (I.cylinder_ts(scene.cylinders, ro, rd, t_min) < tf).any(-1)
    return hit


def make_bvh_occlusion_fn(scene, cfg, tables: TriTables | None = None):
    """occluded(ro, rd, t_far) -> (R,) bool: anything in [t_min, t_far)?
    Analytic primitives by dense sweeps, triangles by the any-hit query;
    lanes with ``t_far <= t_min`` are dead and never report a hit."""
    bvh = scene.tri_bvh
    if bvh is None:
        raise ValueError("scene has no tri_bvh; build it with with_bvh=True")
    tables = tri_tables(bvh) if tables is None else tables
    tri_hit = pick_tri_hit(tables, cfg)

    @torch.no_grad()
    def occluded(ro, rd, t_far):
        hit = analytic_occluded(scene, ro, rd, t_far, cfg.t_min)
        # lanes an analytic primitive already occludes are dead for the
        # triangle query
        tf_tri = torch.where(hit, 0.0, t_far)
        with profiling.span("traverse.any"):
            _, slot = sorted_tri_hit(tables, tri_hit, cfg, ro, rd, tf_tri,
                                     any_hit=True)
            count_query(ro, tf_tri, cfg.t_min, slot)
        valid_tri = (slot >= 0) & (
            tables.tri_index[torch.clamp(slot, min=0).long()] >= 0)
        return hit | valid_tri

    return occluded
