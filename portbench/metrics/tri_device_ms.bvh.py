"""Device ms per traced launch of the operations launched inside the
program's ``traverse.closest`` spans: the wavefront route's closest-hit
triangle queries with their coherence sort, scatter and counts (profiler
trace, each operation put down to the innermost span open when it was
launched, ``spans.attribute``; no span opens within this one)."""

from portbench.spans import attribution


def read(rec):
    a = attribution(rec.trace)
    if a is None or not rec.trace.launches or "traverse.closest" not in a[
            "device_s"]:
        return None
    return a["device_s"]["traverse.closest"] / rec.trace.launches * 1e3
