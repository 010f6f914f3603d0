"""Host ms per traced launch inside the program's ``render.block`` spans:
the host's issue of the launch's blocks, from the camera rays to the last
sort; the launch's wall less this is its wait at the sync (the recorder's
spans over the traced launches, ``spans.SpanReading.program``)."""

from portbench.spans import host_ms_per_launch


def read(rec):
    return host_ms_per_launch(rec, "render.block")
