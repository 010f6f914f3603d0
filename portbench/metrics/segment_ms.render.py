"""Device time per traced launch of the segment kernel (``csrc/mega.cu``,
entry ``mega_kernel``), summed over the launch's segments, in ms
(profiler trace)."""

from portbench.trace import SEGMENT_KERNEL


def read(rec):
    t = rec.trace
    if t is None or not t.launches or not t.kernels:
        return None
    ms = t.device_s(match=SEGMENT_KERNEL) / t.launches * 1e3
    return ms if ms > 0 else None
