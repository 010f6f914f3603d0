"""Device ms per traced launch of the operations launched inside the
program's ``mega.lights`` spans: ``sample_lights`` and its 3x3 gemv
(profiler trace, each operation put down to the innermost span open when
it was launched, ``spans.attribute``)."""

from portbench.spans import attribution


def read(rec):
    a = attribution(rec.trace)
    if a is None or not rec.trace.launches or "mega.lights" not in a[
            "device_s"]:
        return None
    return a["device_s"]["mega.lights"] / rec.trace.launches * 1e3
