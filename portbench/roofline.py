"""The least time one H100 could take for a segment launch.

Frozen copy of ``chip_smoke.py``'s ``bound`` and ``segment_bound`` at
commit 7999567 (last changed in c7b6d06), with its peaks and its
operation constants. Bytes and operations are computed counts, from the
segment's shapes and from the live rays and triangle hits its own records
show, not readings: each input read once and each output written once,
and the float32 operations the live rays need.
"""

import torch

# NVIDIA H100 SXM data sheet: device memory bytes/s and float32 FLOP/s
# outside the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# float32 operations each step needs at least: a slab test of one box
# (6 subtractions, 6 products, 6 min/max and 2 compares), the plane part
# of a triangle test (two 3-term dot products, one division, 2 compares),
# the shading of one bounce (BSDF sample, evaluation and pdf, twice with
# NEE: a few hundred)
SLAB_FLOP = 20
TRI_FLOP = 13
SHADE_FLOP = 300
# the packed LBVH's sub-boxes per leaf and triangles per sub-box
SUB = 16
SUB_TRIS = 8


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time to move nbytes once and do
    flops float32 operations."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def segment_bound(state, tables, seg, rad):
    """Bound of one segment launch: every ray's state read and written and
    its radiance and records written; the tables read once; for each
    ray-bounce live at its start, the uniforms the kernel reads there (4
    planes: roulette and BSDF sample) and, with NEE, the light sample (10
    planes). Operations from the launch's records (per live ray and
    bounce, the shading and the two root slab tests of each query; per
    triangle hit, a walk to the leaf's depth, the leaf's sub-boxes and one
    sub-box's triangles)."""
    nf = seg.n_fused
    alive_in = state[10:11] > 0.5
    live = torch.cat([alive_in, rad[3 + 2 * nf:3 + 3 * nf - 1] > 0.5], 0)
    n_live = int(live.sum())
    live_planes = 4 + (10 if seg.do_nee else 0)
    nbytes = 4 * (2 * state.numel() + rad.numel() + n_live * live_planes
                  + tables.consts.numel() + tables.tri_lm.numel()
                  + tables.sub.numel() + tables.tri_mat.numel()
                  + tables.nodes.numel())
    tri = int(((rad[3:3 + nf] >= tables.meta.tri_base) & live).sum())
    depth = max(tables.n_leaves.bit_length() - 1, 0)
    flops = (n_live * (SHADE_FLOP + 2 * 2 * SLAB_FLOP)
             + tri * ((2 * depth + SUB) * SLAB_FLOP + SUB_TRIS * TRI_FLOP))
    return bound(nbytes, flops)
