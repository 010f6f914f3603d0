"""Packet-walk triangle query (counterpart of
``offline_raytracer_tpu/ops/traverse_pallas.py``; "pallas" named the TPU
kernel language there).

The walk (``csrc/traverse_packet.cu``): one warp is a packet of 32 rays
with one node stack over the implicit-heap LBVH; internal nodes slab-test
both child boxes and push each child any ray wants, nearer child popped
first; leaves sweep their 128 triangles. ``bvh_hit_ts_packet`` takes the
kernel for CUDA tensors and the plain dense sweep
(``traverse.tri_hit_plain``) for CPU tensors; there is no fallback from
one to the other. Contract: ``ops/traverse.py``.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.ops.traverse import (
    TriTables, check_query, pad_rays, tri_hit_plain)

BLOCK = 128         # rays per CUDA block (4 packets); rays pad to it
STACK = 64          # the kernel's node stack

# launches of the CUDA kernel; chip runs read it to prove a route went
# through the kernel
KERNEL_LAUNCHES = 0


def bvh_hit_ts_packet_cuda(tables: TriTables, ro, rd, t_min, t_far=None,
                           any_hit: bool = False):
    """The packet walk kernel (csrc/traverse_packet.cu) on CUDA tensors.
    Launches on the current stream, no sync."""
    global KERNEL_LAUNCHES
    from offline_raytracer_tpu_torch.ops import _kernels

    check_query(tables, ro, rd, t_far, "cuda")
    depth = max(tables.n_leaves - 1, 0).bit_length()
    if depth + 2 > STACK:
        raise ValueError(f"tree of {tables.n_leaves} leaves is deeper than "
                         f"the kernel's {STACK}-entry stack")
    fn = _kernels.load("traverse_packet")
    R = ro.shape[0]
    ro_p, rd_p, tf_p = pad_rays(ro, rd, t_far, BLOCK)
    Rp = ro_p.shape[0]
    t = torch.empty((Rp,), dtype=torch.float32, device=ro.device)
    slot = torch.empty((Rp,), dtype=torch.int32, device=ro.device)
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ro_p.data_ptr(), rd_p.data_ptr(), tf_p.data_ptr(),
                 tables.tri.data_ptr(), tables.nodes.data_ptr(),
                 t.data_ptr(), slot.data_ptr(), Rp, tables.n_leaves,
                 tables.m_occ, int(any_hit), float(t_min), stream)
    if err != 0:
        raise RuntimeError(f"traverse_packet kernel launch failed: CUDA "
                           f"error {err}")
    KERNEL_LAUNCHES += 1
    t, slot = t[:R], slot[:R]
    return torch.where(slot >= 0, t, float("inf")), slot


def bvh_hit_ts_packet(tables: TriTables, ro, rd, t_min, t_far=None,
                      any_hit: bool = False):
    """Packet-walk closest or any hit: the kernel for CUDA tensors, the
    plain dense sweep for CPU tensors, an error for anything else."""
    if ro.device.type == "cuda":
        return bvh_hit_ts_packet_cuda(tables, ro, rd, t_min, t_far, any_hit)
    if ro.device.type == "cpu":
        return tri_hit_plain(tables, ro, rd, t_min, t_far, any_hit)
    raise ValueError(f"no triangle query for device {ro.device}")
