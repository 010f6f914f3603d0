"""Cull-and-sweep triangle query (counterpart of
``offline_raytracer_tpu/ops/traverse_cull.py``).

On the TPU the query is two steps: a dense cull of every ray against every
leaf box, reduced to one list of wanted leaves per 128-ray row in HBM
(the JAX package's ``block_leaf_lists``), then the kernel's sweep of each
row's listed leaves. The kernel here (``csrc/traverse_cull.cu``) does
both in one launch: each block takes a row of rays, culls them against the
leaf boxes itself (conservatively: a NaN slab never rejects, and a
relative slack of 1e-5 widens both ends), ORs the wanted bits over the row
in shared memory and sweeps the listed leaves in leaf-id order, a group of
G lanes per ray and each leaf through its 16 sub-boxes
(``csrc/leaf_sweep.cuh``). ``row_cull_plain`` is the plain version of that
cull.

``bvh_hit_ts_cull`` takes the kernel for CUDA tensors and the plain dense
sweep (``traverse.tri_hit_plain``) for CPU tensors
(``ops/_kernels.takes_kernel``); there is no fallback from one to the
other. Contract: ``ops/traverse.py``.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.ops import _kernels
from offline_raytracer_tpu_torch.ops.traverse import (
    TriTables, check_query, group_size, launch_query, live_rays,
    tri_hit_plain)

LANE = 128          # rays per row of the JAX package's lists
MAX_CULL_LEAVES = 4096   # the kernel's row bitmap: 128 words of shared memory
CHUNK_RAYS = 16384
SLACK = 1.00001     # relative slack of the conservative cull

# launches of the CUDA kernel; chip runs read it to prove a route went
# through the kernel
KERNEL_LAUNCHES = 0


def cull_ok(tables: TriTables) -> bool:
    return (tables.leaf_bounds is not None
            and tables.leaf_bounds.shape[1] <= MAX_CULL_LEAVES)


def row_cull_plain(tables: TriTables, ro, rd, t_min, t_far=None,
                   rays_per_row: int = LANE):
    """The kernel's row cull in plain torch: (ceil(R / rays_per_row),
    m_occ) bool, the leaves any live ray of each row may hit, by the
    kernel's conservative slab test (an axis whose slab is NaN, a ray in a
    face's plane, is skipped; both ends widened by ``SLACK``; an inverted
    box never wanted). A row's list is its True leaves in leaf-id order."""
    m = tables.m_occ
    lb = tables.leaf_bounds[:, :m]
    R = ro.shape[0]
    tf_ray = (torch.full((R,), float("inf"), device=ro.device)
              if t_far is None else t_far)
    live = live_rays(ro, t_far, t_min)
    flags = []
    for r0 in range(0, R, CHUNK_RAYS):
        o, inv = ro[r0:r0 + CHUNK_RAYS], 1.0 / rd[r0:r0 + CHUNK_RAYS]
        tn = torch.full((o.shape[0], m), -float("inf"), device=ro.device)
        tf = torch.full((o.shape[0], m), float("inf"), device=ro.device)
        for k in range(3):
            a = (lb[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
            b = (lb[k + 3][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
            skip = torch.isnan(a) | torch.isnan(b)
            tn = torch.where(skip, tn, torch.maximum(tn, torch.minimum(a, b)))
            tf = torch.where(skip, tf, torch.minimum(tf, torch.maximum(a, b)))
        near = torch.clamp(tn, min=0.0)
        lim = tf_ray[r0:r0 + CHUNK_RAYS, None]
        flags.append((tf * SLACK >= near) & (near <= lim * SLACK)
                     & (lb[0] <= lb[3])[None, :]
                     & live[r0:r0 + CHUNK_RAYS, None])
    wants = torch.cat(flags)
    pad = -R % rays_per_row
    wants = torch.cat([wants, wants.new_zeros((pad, m))])
    return wants.reshape(-1, rays_per_row, m).any(1)


def bvh_hit_ts_cull_cuda(tables: TriTables, ro, rd, t_min, t_far=None,
                         any_hit: bool = False, group: int | None = None):
    """The cull-and-sweep kernel (csrc/traverse_cull.cu) on CUDA tensors:
    one launch, no (R, L) array. ``group``: lanes per ray (default:
    ``group_size`` of the ray count); it changes no output. Launches on
    the current stream."""
    global KERNEL_LAUNCHES

    check_query(tables, ro, rd, t_far, "cuda")
    lw = tables.leaf_bounds.shape[1]
    if not cull_ok(tables):
        raise ValueError(f"{lw} leaf lanes: the cull kernel takes at most "
                         f"{MAX_CULL_LEAVES}")
    if group is None:
        group = group_size(ro.shape[0])
    out = launch_query(
        "traverse_cull", ro, rd, t_min, t_far, any_hit, group,
        (tables.leaf_bounds.data_ptr(), tables.tri_lm.data_ptr(),
         tables.sub.data_ptr()), (tables.m_occ, lw))
    KERNEL_LAUNCHES += 1
    return out


def bvh_hit_ts_cull(tables: TriTables, ro, rd, t_min, t_far=None,
                    any_hit: bool = False):
    """Cull-and-sweep closest or any hit: the kernel for CUDA tensors, the
    plain dense sweep for CPU tensors, an error for anything else."""
    if _kernels.takes_kernel(ro.device, "triangle query"):
        return bvh_hit_ts_cull_cuda(tables, ro, rd, t_min, t_far, any_hit)
    return tri_hit_plain(tables, ro, rd, t_min, t_far, any_hit)
