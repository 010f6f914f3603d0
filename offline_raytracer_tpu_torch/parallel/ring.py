"""Geometry split over processes: ray blocks rotate over a ring of ranks
(counterpart of ``offline_raytracer_tpu/parallel/ring.py``).

When the BVH is too large to hold whole on every card, the triangles are
cut into Morton-contiguous ranges, one LBVH per range, and each rank holds
one (``prepare_ring_shards``). Every triangle query of the wavefront
becomes S steps over the S ranks: a rank queries its shard with the block
of rays it holds, merges the answer into the block's running winner, and
passes the block to rank + 1 (``shard.ring_shift``, send and receive posted
together). After S steps each block is home with the closest hit over
every shard. The triangles' vertices, materials, lights and camera stay
whole on every rank: the hit refine and the shading read them.

Each step's query is the wavefront's (``traverse.pick_tri_hit``): the cull
kernel when the shard qualifies, else the packet kernel, on the card; the
plain dense sweep on the CPU. Two rules carry over from the JAX ring: the
merge takes a shard's hit only when strictly nearer, so a tie between
shards goes to the one visited first, starting at the block's home rank;
and a shadow ray already occluded rotates with ``t_far = 0``, dead at every
later shard. The port's dead mark carries over as well: lanes the
integrator passes as not alive go to every query with ``t_far = 0``. The
closest-hit query is bounded by the block's running winner, which keeps
the same winner under the strict merge and lets later shards prune.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.integrator import trace_paths
from offline_raytracer_tpu_torch.ops import intersect as I
from offline_raytracer_tpu_torch.ops.bvh import (
    LEAF, TriBVH, build_tri_bvh, morton_codes)
from offline_raytracer_tpu_torch.ops.traverse import (
    INF, TriTables, analytic_occluded, pick_tri_hit, sorted_tri_hit,
    tri_tables)
from offline_raytracer_tpu_torch.parallel.shard import (
    RankGroup, all_gather, rank_block, ring_shift)
from offline_raytracer_tpu_torch.render import _accumulate
from offline_raytracer_tpu_torch.scene.types import Scene


def shard_ids(v0, v1, v2, n_shards: int) -> list:
    """Triangle ids of each of ``n_shards`` Morton-contiguous ranges of
    ``per`` ids, ``per`` the least multiple of 128 that covers them all: a
    short range is padded by repeating its last id, and an empty one (more
    shards than leaves) takes the last id of the Morton order."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    n = v0.shape[0]
    if n == 0:
        raise ValueError("empty triangle set")
    order = np.argsort(morton_codes((v0 + v1 + v2) / 3.0),
                       kind="stable").astype(np.int32)
    per = -(-n // (n_shards * LEAF)) * LEAF
    out = []
    for s in range(n_shards):
        ids = order[s * per:(s + 1) * per]
        if ids.size == 0:
            ids = order[-1:]
        out.append(np.concatenate(
            [ids, np.full(per - ids.size, ids[-1], np.int32)]))
    return out


def build_bvh_shard(v0, v1, v2, ids) -> TriBVH:
    """The LBVH, sub-boxes included, of triangles ``ids`` (numpy, on the
    CPU), its ``tri_index`` holding global triangle ids. A repeated id
    reports the same hit as its original."""
    v0, v1, v2 = (np.asarray(v, np.float32)[ids] for v in (v0, v1, v2))
    b = build_tri_bvh(v0, v1, v2, np.zeros(ids.size, np.int32))
    local = b.tri_index.numpy()
    glob = np.where(local >= 0, ids[np.clip(local, 0, ids.size - 1)], -1)
    return dataclasses.replace(
        b, tri_index=torch.from_numpy(glob.astype(np.int32)))


def build_bvh_shards(v0, v1, v2, n_shards: int) -> list:
    """[TriBVH] of every shard (``shard_ids``, ``build_bvh_shard``)."""
    return [build_bvh_shard(v0, v1, v2, ids)
            for ids in shard_ids(v0, v1, v2, n_shards)]


def prepare_ring_shards(scene: Scene, group: RankGroup) -> TriTables:
    """This rank's shard of the scene's triangles, built on the host and
    kept on the rank's device as the queries' tables: 1 / S of the BVH.
    Build it once per scene and group and pass it to each
    ``render_block_ring`` call."""
    v = [x.detach().cpu().numpy() for x in (
        scene.triangles.v0, scene.triangles.v1, scene.triangles.v2)]
    ids = shard_ids(*v, group.size)[group.rank]
    return tri_tables(build_bvh_shard(*v, ids).to(group.device))


def _global_ids(tables: TriTables, slot):
    return torch.where(
        slot >= 0, tables.tri_index[torch.clamp(slot, min=0).long()], -1)


def _ring_tri_hit(tables, tri_hit, cfg, group, ro, rd, best_t, t_far):
    """Closest triangle hit over every shard, in S steps -> (t, global
    triangle id, -1 where no triangle is strictly nearer than ``best_t``)
    for the block's own rays. ``t_far``: (R,) 0 on dead lanes, inf on live
    ones."""
    best_id = torch.full(best_t.shape, -1, dtype=torch.int32,
                         device=ro.device)
    for _ in range(group.size):
        t, slot = sorted_tri_hit(tables, tri_hit, cfg, ro, rd,
                                 torch.minimum(t_far, best_t))
        gid = _global_ids(tables, slot)
        better = (t < best_t) & (gid >= 0)
        best_t = torch.where(better, t, best_t)
        best_id = torch.where(better, gid, best_id)
        if group.size > 1:
            block = ring_shift(group, torch.cat(
                [ro, rd, best_t[:, None], best_id.view(torch.float32)[:, None],
                 t_far[:, None]], 1))
            ro, rd = block[:, 0:3].contiguous(), block[:, 3:6].contiguous()
            best_t, t_far = block[:, 6].contiguous(), block[:, 8].contiguous()
            best_id = block[:, 7].contiguous().view(torch.int32)
    return best_t, best_id


def _ring_tri_occluded(tables, tri_hit, cfg, group, ro, rd, t_far):
    """Any triangle of any shard in [t_min, t_far)? S steps; a lane found
    occluded rotates on with ``t_far = 0``."""
    occ = torch.zeros(ro.shape[:1], dtype=torch.bool, device=ro.device)
    for _ in range(group.size):
        _, slot = sorted_tri_hit(tables, tri_hit, cfg, ro, rd, t_far,
                                 any_hit=True)
        occ = occ | (_global_ids(tables, slot) >= 0)
        t_far = torch.where(occ, 0.0, t_far)
        if group.size > 1:
            block = ring_shift(group, torch.cat(
                [ro, rd, t_far[:, None], occ[:, None].float()], 1))
            ro, rd = block[:, 0:3].contiguous(), block[:, 3:6].contiguous()
            t_far, occ = block[:, 6].contiguous(), block[:, 7] > 0.5
    return occ


def make_ring_trace_fn(scene: Scene, cfg: RenderConfig, tables: TriTables,
                       group: RankGroup):
    """Closest-hit function (ro, rd, alive=None) -> Hit, the same on every
    rank of the ring: dense sweeps of the analytic primitives, the ring of
    triangle queries, one differentiable ``refine_hit`` of the winner.
    ``alive``: the lanes whose hit is wanted; the others go to every shard
    and to the sphere kernel dead."""
    tri_hit = pick_tri_hit(tables, cfg)

    def trace(ro, rd, alive=None):
        with torch.no_grad():
            best = I.Closest(ro.shape[0], ro.device)
            best.consider_analytic(scene, ro, rd, cfg.t_min, alive)
            t_far = (torch.full_like(best.t, INF) if alive is None
                     else torch.where(alive, INF, 0.0))
            tt, tri_id = _ring_tri_hit(tables, tri_hit, cfg, group, ro, rd,
                                       best.t, t_far)
            won = tri_id >= 0
            best.t = torch.where(won, tt, best.t)
            best.type = torch.where(won, I.TRIANGLE, best.type).to(
                torch.int32)
            best.idx = torch.where(won, tri_id, best.idx)
        return I.refine_hit(scene, ro, rd, cfg.t_min, best.type, best.idx,
                            best.t < INF)

    return trace


def make_ring_occlusion_fn(scene: Scene, cfg: RenderConfig,
                           tables: TriTables, group: RankGroup):
    """occluded(ro, rd, t_far) -> (R,) bool, the same on every rank of the
    ring: the analytic primitives by dense sweeps, then the any-hit ring for
    the lanes they leave open; lanes with ``t_far <= t_min`` are dead."""
    tri_hit = pick_tri_hit(tables, cfg)

    @torch.no_grad()
    def occluded(ro, rd, t_far):
        hit = analytic_occluded(scene, ro, rd, t_far, cfg.t_min)
        return hit | _ring_tri_occluded(tables, tri_hit, cfg, group, ro, rd,
                                        torch.where(hit, 0.0, t_far))

    return occluded


def render_block_ring(scene: Scene, cfg: RenderConfig, group: RankGroup,
                      pixel_ids, sample_lo: int = 0,
                      n_samples: int | None = None,
                      shards: TriTables | None = None):
    """Render ``pixel_ids`` (P,), the same on every rank, with the rays and
    the triangles split over the ranks -> (P, 3) on every rank.

    Each rank traces its block of pixels through the wavefront
    (``integrator.trace_paths``) with the ring's queries; every bounce costs
    S closest-hit and, with NEE, S shadow steps on each rank. P must divide
    by the group size. ``shards``: the ``prepare_ring_shards`` result,
    built here if None."""
    n = cfg.spp if n_samples is None else n_samples
    tables = prepare_ring_shards(scene, group) if shards is None else shards
    scene_rep = dataclasses.replace(scene, tri_bvh=None)
    trace = make_ring_trace_fn(scene_rep, cfg, tables, group)
    occl = make_ring_occlusion_fn(scene_rep, cfg, tables, group)

    def paths(ro, rd, keys, collect_stats=False):
        return trace_paths(scene_rep, cfg, trace, ro, rd, keys,
                           collect_stats=collect_stats, occl_fn=occl)

    out, _ = _accumulate(paths, scene_rep, cfg, rank_block(group, pixel_ids),
                         sample_lo, n, False)
    return all_gather(group, out)
