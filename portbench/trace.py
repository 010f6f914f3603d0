"""The traced run's device trace, read from ``torch.profiler``.

``Tracer`` profiles the CPU and the card over the traced launches of a
``--trace 1`` run and reads the raw events back (the profiler's own
event objects are built lazily and cost seconds per hundred thousand
events, so they are not used). A ``TraceReading`` holds:

- ``kernels``: [(name, start_ns, end_ns)] of every operation that ran on
  the card (kernels, copies, fills);
- ``host``: [(name, start_ns)] of the host's operators, for the labels of
  idle gaps;
- ``window_s``: the host clock's wall over the traced launches.

``busy_s`` is the union of the device intervals; ``breakdown`` the
device operations that took most time and the idle gaps summed by what
the host was issuing when each began.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

# the segment kernel's entry (``csrc/mega.cu``) as the trace names it: the
# segment readers split the device time on it, and the render loop fails
# a traced run whose segment launches do not all show under it
SEGMENT_KERNEL = "mega_kernel"
# characters of an operation's name kept (C++ template names run long)
NAME_CHARS = 160
# the profiler's activity types of work on the card (its step annotations,
# "gpu_user_annotation", span the whole step and are not work)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(ev):
    """(start_ns, end_ns) of a raw profiler event, over torch versions."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.end_ns()
    start = ev.start_us() * 1000
    return start, start + ev.duration_us() * 1000


@dataclasses.dataclass
class TraceReading:
    kernels: list
    host: list
    window_s: float
    launches: int

    def intervals(self):
        """Sorted (start, end) of the device operations."""
        return sorted((s, e) for _, s, e in self.kernels)

    def device_s(self, match=None, exclude=None) -> float:
        """Summed device time of the operations whose name contains
        ``match`` and not ``exclude``."""
        return sum(e - s for n, s, e in self.kernels
                   if (match is None or match in n)
                   and (exclude is None or exclude not in n)) / 1e9

    def count(self, match: str) -> int:
        """Device operations whose name contains ``match``."""
        return sum(match in n for n, _, _ in self.kernels)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        busy, end = 0, None
        for s, e in self.intervals():
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": [[name, s]], "idle_gaps": [[host op, s]]}."""
        per = collections.Counter()
        for n, s, e in self.kernels:
            per[n] += (e - s) / 1e9
        gaps = collections.Counter()
        starts = [t for _, t in self.host]
        end = None
        for s, e in self.intervals():
            if end is not None and s > end:
                i = bisect.bisect_right(starts, end) - 1
                label = self.host[i][0] if i >= 0 else "(before the trace)"
                gaps[label] += (s - end) / 1e9
            end = e if end is None else max(end, e)
        return {"device_ops": [[n, v] for n, v in per.most_common(top)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


def idle_pct(rec):
    """The card's idle share over a record's traced launches or steps, in
    percent: one minus the union of the device operations' intervals over
    the host clock's wall of those launches (the profiler's own host
    overhead, and any syncs the loop adds there, widen the wall); None
    without a device trace."""
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


class Tracer:
    """Profiles the card and the host over ``active`` launches.

    The profiler starts in set-up, where its first steps (``warmup``,
    whose events it drops) pay its start-up; ``step`` after every launch
    moves it on, and the ``active`` launches after the warm-up ones are
    recorded."""

    def __init__(self, warmup: int, active: int):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=warmup, active=active, repeat=1))

    def start(self):
        self._prof.start()

    def step(self):
        self._prof.step()

    def stop(self, window_s: float, launches: int) -> TraceReading:
        from torch.autograd import DeviceType

        self._prof.stop()
        kernels, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            start, end = _ns(ev)
            name = ev.name()[:NAME_CHARS]
            kind = (ev.activity_type() if hasattr(ev, "activity_type")
                    else "")
            if ev.device_type() == DeviceType.CPU:
                # the host's operators; not its runtime calls or the
                # profiler's own step annotations
                if kind in ("cpu_op", "") and not name.startswith(
                        ("cuda", "cu", "Runtime", "ProfilerStep")):
                    host.append((name, start))
            elif (kind in DEVICE_KINDS
                  or (not kind and not name.startswith("ProfilerStep"))):
                kernels.append((name, start, end))
        host.sort(key=lambda x: x[1])
        return TraceReading(kernels=kernels, host=host, window_s=window_s,
                            launches=launches)
