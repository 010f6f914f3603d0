"""Cull-and-sweep triangle query (counterpart of
``offline_raytracer_tpu/ops/traverse_cull.py``).

1. Dense cull (``block_leaf_lists``, plain torch as in the JAX package):
   slab-test every ray against every leaf box and reduce the wanted flags
   over each 128-ray row to that row's list of wanted leaves, in leaf-id
   order, and its length. Done in chunks of rays so no (R, L) temporary
   outgrows a few tens of MB.
2. Listed-leaf sweep (``csrc/traverse_cull.cu``): one CUDA block per row,
   one thread per ray; the block walks its row's list and sweeps each
   listed leaf's 128 triangles.

The host sorts rows by list length, longest first, so the longest rows
start first. ``bvh_hit_ts_cull`` takes the kernel for CUDA tensors and the
plain dense sweep (``traverse.tri_hit_plain``) for CPU tensors; there is
no fallback from one to the other. Contract: ``ops/traverse.py``.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.ops.traverse import (
    TriTables, check_query, pad_rays, tri_hit_plain)

LANE = 128          # rays per row (one list, one CUDA block)
MAX_CULL_LEAVES = 4096   # beyond this the (R, L) cull outgrows a tree walk
CHUNK_RAYS = 16384

# launches of the CUDA kernel; chip runs read it to prove a route went
# through the kernel
KERNEL_LAUNCHES = 0


def cull_ok(tables: TriTables) -> bool:
    return (tables.leaf_bounds is not None
            and tables.leaf_bounds.shape[1] <= MAX_CULL_LEAVES)


def block_leaf_lists(leaf_bounds, m_occ: int, ro, rd, t_bound,
                     block: int = LANE):
    """Dense cull -> per-block wanted-leaf lists.

    ro, rd: (R, 3) with R a multiple of ``block``; ``t_bound``: (R,) far
    bound (inf for closest hit, the light distance for shadow rays, <= 0
    for a dead lane). Returns (lists (R / block, L) int32, counts
    (R / block, 1) int32): lists[b, :counts[b]] are the leaves any ray of
    block b may hit, in leaf-id order, followed by the others.
    """
    lb = leaf_bounds
    L = lb.shape[1]
    R = ro.shape[0]
    iota = torch.arange(L, dtype=torch.int32, device=ro.device)
    occupied = iota[None, :] < m_occ
    step = max(block, CHUNK_RAYS // block * block)
    flags = []
    for r0 in range(0, R, step):
        o, inv = ro[r0:r0 + step], 1.0 / rd[r0:r0 + step]

        def axis_ts(k):
            t0 = (lb[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
            t1 = (lb[k + 3][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
            return torch.minimum(t0, t1), torch.maximum(t0, t1)

        n0, f0 = axis_ts(0)
        n1, f1 = axis_ts(1)
        n2, f2 = axis_ts(2)
        tn = torch.maximum(torch.maximum(n0, n1), n2)
        tf = torch.minimum(torch.minimum(f0, f1), f2)
        near = torch.clamp(tn, min=0.0)
        wants = ((tf >= near) & (near < t_bound[r0:r0 + step, None])
                 & occupied)
        flags.append(wants.reshape(-1, block, L).any(1))
    flags = torch.cat(flags)
    key = torch.where(flags, iota[None, :], L + iota[None, :])
    lists = torch.argsort(key, dim=1).to(torch.int32)
    counts = flags.sum(1, dtype=torch.int32)[:, None]
    return lists, counts


def cull_inputs(tables: TriTables, ro, rd, t_far=None):
    """Host half of the query: rays padded to whole rows (pad rays parked
    far outside the scene, dead), per-row lists and counts, and the rows
    in launch order (longest list first).

    Returns (ro_p (Rp, 3), rd_p (Rp, 3), tf_p (Rp,), lists (Rp/128, L)
    int32, counts (Rp/128,) int32, rows (Rp/128,) int32).
    """
    ro_p, rd_p, tf_p = pad_rays(ro, rd, t_far, LANE)
    lists, counts = block_leaf_lists(tables.leaf_bounds, tables.m_occ, ro_p,
                                     rd_p, tf_p)
    counts = counts[:, 0].contiguous()
    rows = torch.argsort(counts, descending=True, stable=True).to(
        torch.int32)
    return ro_p, rd_p, tf_p, lists.contiguous(), counts, rows.contiguous()


def sweep_cuda(tables: TriTables, inputs, t_min, any_hit: bool = False):
    """Launch the listed-leaf sweep kernel (csrc/traverse_cull.cu) on the
    host half's output (``cull_inputs``): -> (t (Rp,), slot (Rp,)) raw,
    t_far where nothing was hit. Launches on the current stream, no sync."""
    global KERNEL_LAUNCHES
    from offline_raytracer_tpu_torch.ops import _kernels

    ro_p, rd_p, tf_p, lists, counts, rows = inputs
    fn = _kernels.load("traverse_cull")
    Rp = ro_p.shape[0]
    t = torch.empty((Rp,), dtype=torch.float32, device=ro_p.device)
    slot = torch.empty((Rp,), dtype=torch.int32, device=ro_p.device)
    with torch.cuda.device(ro_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ro_p.data_ptr(), rd_p.data_ptr(), tf_p.data_ptr(),
                 lists.data_ptr(), counts.data_ptr(), rows.data_ptr(),
                 tables.tri.data_ptr(), t.data_ptr(), slot.data_ptr(),
                 Rp // LANE, lists.shape[1], int(any_hit), float(t_min),
                 stream)
    if err != 0:
        raise RuntimeError(f"traverse_cull kernel launch failed: CUDA "
                           f"error {err}")
    KERNEL_LAUNCHES += 1
    return t, slot


def bvh_hit_ts_cull_cuda(tables: TriTables, ro, rd, t_min, t_far=None,
                         any_hit: bool = False):
    """Dense cull, then the listed-leaf sweep kernel, on CUDA tensors."""
    check_query(tables, ro, rd, t_far, "cuda")
    R = ro.shape[0]
    t, slot = sweep_cuda(tables, cull_inputs(tables, ro, rd, t_far), t_min,
                         any_hit)
    t, slot = t[:R], slot[:R]
    return torch.where(slot >= 0, t, float("inf")), slot


def bvh_hit_ts_cull(tables: TriTables, ro, rd, t_min, t_far=None,
                    any_hit: bool = False):
    """Cull-and-sweep closest or any hit: the kernel for CUDA tensors, the
    plain dense sweep for CPU tensors, an error for anything else."""
    if ro.device.type == "cuda":
        return bvh_hit_ts_cull_cuda(tables, ro, rd, t_min, t_far, any_hit)
    if ro.device.type == "cpu":
        return tri_hit_plain(tables, ro, rd, t_min, t_far, any_hit)
    raise ValueError(f"no triangle query for device {ro.device}")

