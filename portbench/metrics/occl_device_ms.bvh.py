"""Device ms per traced launch of the operations launched inside the
program's ``wave.occlusion`` spans: NEE's shadow queries, the analytic
sweeps in ``wave.occlusion``'s own time and the any-hit triangle query
with its coherence sort, scatter and counts in the ``traverse.any`` span
within it (profiler trace, each operation put down to the innermost span
open when it was launched, ``spans.attribute``; the two summed)."""

from portbench.spans import attribution

SPANS = ("wave.occlusion", "traverse.any")


def read(rec):
    a = attribution(rec.trace)
    if a is None or not rec.trace.launches or not any(
            k in a["device_s"] for k in SPANS):
        return None
    return sum(a["device_s"][k] for k in SPANS) / rec.trace.launches * 1e3
