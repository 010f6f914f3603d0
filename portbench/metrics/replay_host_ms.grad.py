"""Host ms per traced step inside the program's ``replay.forward`` spans:
the replay's eager forward (``integrator.trace_paths(replay=...)``; the
recorder's spans over the traced steps)."""

from portbench.spans import host_ms_per_launch


def read(rec):
    return host_ms_per_launch(rec, "replay.forward")
