"""Device ms per traced launch of the operations launched inside the
program's ``wave.hit`` spans: the wavefront route's closest-hit query of
every bounce (for spheres, ``intersect.sphere_ts``'s all-pairs sweep and
``refine_hit``; profiler trace, each operation put down to the innermost
span open when it was launched, ``spans.attribute``)."""

from portbench.spans import attribution


def read(rec):
    a = attribution(rec.trace)
    if a is None or not rec.trace.launches or "wave.hit" not in a[
            "device_s"]:
        return None
    return a["device_s"]["wave.hit"] / rec.trace.launches * 1e3
