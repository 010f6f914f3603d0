"""The least time one H100 could take for the wavefront route's triangle
queries through the cull kernel.

Frozen copy of ``chip_smoke.py``'s ``query_bound`` (and its ``bound``,
peaks and operation constants) at commit 356a876, summed over the traced
launches' queries: per query, the rays' origins, directions and bounds
read once (28 bytes a lane) and their (t, slot) written once (8 bytes),
and the tables the kernel reads (the leaf boxes, the leaf-major
coefficient rows, the sub-boxes) read once; per live ray two root slab
tests, per hit a walk to the leaf's depth, the leaf's sub-boxes and one
sub-box's triangles. The lanes, live lanes and hits are the program's
counters ``traverse.rays``, ``traverse.live`` and ``traverse.hits``, the
queries its ``traverse.closest`` and ``traverse.any`` spans and the table
sizes the scene's tree's, so the bound counts the same work whichever
kernel answers the queries.
"""

# NVIDIA H100 SXM data sheet: device memory bytes/s and float32 FLOP/s
# outside the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# float32 operations of a slab test of one box and of the plane part of a
# triangle test (chip_smoke.py)
SLAB_FLOP = 20
TRI_FLOP = 13
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


def queries_bound(queries: int, rays: float, live: float, hits: float,
                  tables: dict):
    """(bound_ms, bound_by) of ``queries`` triangle queries with bounds,
    over ``rays`` lanes in all, ``live`` of them live and ``hits`` of them
    hit; ``tables``: the float32 elements of ``leaf_bounds``, ``tri_lm``
    and ``sub`` and the tree's ``n_leaves``."""
    per_query = tables["leaf_bounds"] + tables["tri_lm"] + tables["sub"]
    nbytes = 4 * ((3 + 3 + 1 + 2) * float(rays) + queries * per_query)
    depth = max(int(tables["n_leaves"]).bit_length() - 1, 0)
    flops = float(live) * 2 * SLAB_FLOP + float(hits) * (
        (2 * depth + SUB) * SLAB_FLOP + SUB_TRIS * TRI_FLOP)
    return bound(nbytes, flops)
