"""The segment kernel's share of its roofline, in percent: the least time
the H100 could take for the traced launches' segments (``roofline.py``:
bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is
longer, computed from each segment's shapes and live rays) over the
kernel's measured device time for them (profiler trace)."""

from portbench.trace import SEGMENT_KERNEL


def read(rec):
    t = rec.trace
    bound_ms = rec.values.get("segment_bound_ms")
    if t is None or bound_ms is None:
        return None
    kernel_ms = t.device_s(match=SEGMENT_KERNEL) * 1e3
    if kernel_ms <= 0:
        return None
    return 100.0 * bound_ms / kernel_ms
