"""Device ms per traced launch of the operations launched inside the
program's ``wave.shade`` spans and not in a span within them: the rest of
each wavefront bounce (its draws, material gathers, the sky, the BSDF
sample, pdf and value, the state's update; profiler trace,
``spans.attribute``)."""

from portbench.spans import attribution


def read(rec):
    a = attribution(rec.trace)
    if a is None or not rec.trace.launches or "wave.shade" not in a[
            "device_s"]:
        return None
    return a["device_s"]["wave.shade"] / rec.trace.launches * 1e3
