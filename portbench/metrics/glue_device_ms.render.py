"""Device time per traced launch of every operation but the segment
kernel, in ms: the host bounce loop's glue (threefry draws, light
samples, coherence sort, compaction) and the launch's keys, camera rays
and sums (profiler trace)."""

from portbench.trace import SEGMENT_KERNEL


def read(rec):
    t = rec.trace
    if t is None or not t.launches or not t.kernels:
        return None
    return t.device_s(exclude=SEGMENT_KERNEL) / t.launches * 1e3
