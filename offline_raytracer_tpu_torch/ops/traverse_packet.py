"""Tree-walk triangle query (counterpart of
``offline_raytracer_tpu/ops/traverse_pallas.py``; "pallas" named the TPU
kernel language there, "packet" names the route).

The TPU kernel walks the implicit-heap LBVH one packet of rays at a time
with a shared node stack. The kernel here (``csrc/traverse_packet.cu``)
does not: it gives each ray a group of G lanes and its own stackless walk
(heap ids and a 32-bit trail), nearer child first, and sweeps each leaf it
reaches through its 16 sub-boxes with the group's lanes
(``csrc/leaf_sweep.cuh``). ``bvh_hit_ts_packet`` takes the kernel for
CUDA tensors and the plain dense sweep (``traverse.tri_hit_plain``) for
CPU tensors (``ops/_kernels.takes_kernel``); there is no fallback from one
to the other. Contract: ``ops/traverse.py``.
"""

from __future__ import annotations

from offline_raytracer_tpu_torch.ops import _kernels
from offline_raytracer_tpu_torch.ops.traverse import (
    TriTables, check_query, group_size, launch_query, tri_hit_plain)

# launches of the CUDA kernel; chip runs read it to prove a route went
# through the kernel
KERNEL_LAUNCHES = 0


def bvh_hit_ts_packet_cuda(tables: TriTables, ro, rd, t_min, t_far=None,
                           any_hit: bool = False, group: int | None = None):
    """The tree walk kernel (csrc/traverse_packet.cu) on CUDA tensors.
    ``group``: lanes per ray (default: ``group_size`` of the ray count); it
    changes no output. Launches on the current stream."""
    global KERNEL_LAUNCHES

    check_query(tables, ro, rd, t_far, "cuda")
    if group is None:
        group = group_size(ro.shape[0])
    out = launch_query(
        "traverse_packet", ro, rd, t_min, t_far, any_hit, group,
        (tables.tri_lm.data_ptr(), tables.sub.data_ptr(),
         tables.nodes.data_ptr()), (tables.n_leaves, tables.m_occ))
    KERNEL_LAUNCHES += 1
    return out


def bvh_hit_ts_packet(tables: TriTables, ro, rd, t_min, t_far=None,
                      any_hit: bool = False):
    """Tree-walk closest or any hit: the kernel for CUDA tensors, the
    plain dense sweep for CPU tensors, an error for anything else."""
    if _kernels.takes_kernel(ro.device, "triangle query"):
        return bvh_hit_ts_packet_cuda(tables, ro, rd, t_min, t_far, any_hit)
    return tri_hit_plain(tables, ro, rd, t_min, t_far, any_hit)
