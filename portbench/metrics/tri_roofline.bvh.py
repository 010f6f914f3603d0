"""The cull kernel's share of its roofline over the traced launches, in
percent: the least time the H100 could take for the program's triangle
queries (``roofline_tri.queries_bound``, from the counters
``traverse.rays``, ``traverse.live`` and ``traverse.hits``, the number of
``traverse.closest`` and ``traverse.any`` spans and the tree's table
sizes) over the device time of the operations whose name holds the cull
kernel's entry, ``cull_kernel`` (``csrc/traverse_cull.cu``; profiler
trace)."""

from portbench.roofline_tri import queries_bound

KERNEL = "cull_kernel"
QUERY_SPANS = ("traverse.closest", "traverse.any")


def read(rec):
    t = rec.trace
    program = getattr(t, "program", None)
    tables = rec.values.get("tri_tables")
    if not program or tables is None:
        return None
    c = program["counters"]
    queries = sum(s["name"] in QUERY_SPANS for s in program["spans"])
    if not queries or any(k not in c for k in (
            "traverse.rays", "traverse.live", "traverse.hits")):
        return None
    kernel_ms = t.device_s(match=KERNEL) * 1e3
    if kernel_ms <= 0:
        return None
    bound_ms, _ = queries_bound(queries, c["traverse.rays"],
                                c["traverse.live"], c["traverse.hits"],
                                tables)
    return 100.0 * bound_ms / kernel_ms
