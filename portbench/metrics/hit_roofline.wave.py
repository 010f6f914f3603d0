"""The wavefront closest-hit query's share of its roofline, in percent: the
least time the H100 could take for the traced launches' ``wave.hit``
queries (``roofline_wave.hit_bound_ms``: each live ray's origin and
direction read once and its distance and id written once, the sphere
table read once a query, at 3.35 TB/s; no sphere test counted) over the
device time of the operations launched inside those spans (profiler
trace, ``spans.attribute``)."""

from portbench.roofline_wave import hit_bound_ms
from portbench.spans import attribution


def read(rec):
    t = rec.trace
    a = attribution(t)
    program = getattr(t, "program", None)
    spheres = rec.values.get("spheres")
    if a is None or not program or spheres is None:
        return None
    queries = sum(s["name"] == "wave.hit" for s in program["spans"])
    live = program["counters"].get("wave.live")
    device_ms = a["device_s"].get("wave.hit", 0.0) * 1e3
    if not queries or live is None or device_ms <= 0:
        return None
    return 100.0 * hit_bound_ms(live, queries, spheres) / device_ms
