"""The program's own spans and counters in a traced run, and the card's
device time and idle time put down to them.

The port records spans and counters (``offline_raytracer_tpu_torch.utils.
profiling``: ``render.block``, ``mega.draws``, ``mega.sort``, ...) while
its recorder is on, and under ``torch.profiler`` each span is also a
``record_function`` event of the trace, on the clock of the device
operations. Here:

- ``SpanTracer`` is ``trace.Tracer`` that also keeps, from the profiler's
  raw events, the program's spans ([(name, start_ns, end_ns, thread)]) and,
  for each device operation, the host call that launched it (the CUDA
  runtime or driver call of the same correlation id: (start_ns, thread)),
  leaves out the card's copies of the host's annotations (the program's
  spans among them: marks, not work), and takes the recorder's flush over
  exactly the traced launches: its
  ``stop`` returns a ``SpanReading``, a ``trace.TraceReading`` with those
  fields added, and prints the device and idle time by span on stderr;
- ``attribute`` puts each device operation down to the innermost program
  span open on its launching thread when it was launched, and each idle
  gap of the card (between the union's busy intervals) down to the
  innermost span open on any thread when the gap began; both to
  ``(outside)`` where no span is open, device operations whose launch is
  not in the trace to ``(unmatched)``;
- ``main`` runs one cell as ``run.py`` does, with the recorder on from the
  start and this tracer in the loop's place, and reads the metrics of
  ``EXTRA`` beside the cell's own in a ``--trace 1`` run:

      python3 portbench/spans.py --workload bunny.render --seed 7 \\
          --seconds 51 --trace 1

  Without ``--trace`` it prints the window's host time per launch by span
  (recorder on, no profiler). The metric readers of ``EXTRA``
  (``metrics/<name>.py``) read a ``SpanReading``; on the loops' own
  ``trace.TraceReading`` they read nothing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench.trace import (  # noqa: E402
    DEVICE_KINDS, NAME_CHARS, SEGMENT_KERNEL, Tracer, TraceReading, _ns)

OUTSIDE = "(outside)"
UNMATCHED = "(unmatched)"
# the host's CUDA runtime and driver calls, which launch the card's work
# (by name: torch builds before 2.13 give no activity type), as
# ``trace.Tracer`` tells them from the host's operators
LAUNCH_PREFIXES = ("cuda", "cu")
# the metrics read from a SpanReading: (name, unit, better, source, moves,
# workloads)
RENDERS = ["bunny.render", "showcase.render"]
EXTRA = [
    ("host_issue_ms.render", "ms", "lower", "program_span", "mrays_per_s",
     RENDERS),
    ("draws_host_ms.render", "ms", "lower", "program_span", "mrays_per_s",
     RENDERS),
    ("sort_host_ms.render", "ms", "lower", "program_span", "mrays_per_s",
     RENDERS),
    ("lights_device_ms.render", "ms", "lower", "device_trace",
     "mrays_per_s", RENDERS),
    ("idle_in_draws_pct.render", "%", "lower", "device_trace",
     "mrays_per_s", RENDERS),
    ("live_lane_pct.render", "%", "higher", "program_counter",
     "mrays_per_s", RENDERS),
    ("replay_host_ms.grad", "ms", "lower", "program_span", "grad_step_ms",
     ["bunny.grad"]),
]


@dataclasses.dataclass
class SpanReading(TraceReading):
    spans: list = dataclasses.field(default_factory=list)
    kernel_calls: list = dataclasses.field(default_factory=list)
    program: dict | None = None


def _flush():
    from offline_raytracer_tpu_torch.utils import profiling

    return profiling.flush() if profiling.enabled() else None


class SpanTracer(Tracer):
    """``trace.Tracer`` keeping the program's spans and each device
    operation's launch call; the recorder is flushed when the traced
    launches begin and again at ``stop``, whose flush the reading
    carries."""

    def __init__(self, warmup: int, active: int):
        super().__init__(warmup, active)
        self._warmup = warmup
        self._steps = 0
        self.before = None      # the recorder's flush up to the trace

    def start(self):
        super().start()
        if self._warmup == 0:
            self.before = _flush()

    def step(self):
        super().step()
        self._steps += 1
        if self._steps == self._warmup:
            self.before = _flush()

    def stop(self, window_s: float, launches: int) -> SpanReading:
        """The trace as ``Tracer.stop`` reads it, less the card's copies of
        the host's annotations (the program's spans, the optimizer's step:
        torch builds before 2.13 give them no activity type, and
        ``Tracer`` counts them as work), with the program's spans and
        each device operation's launch call."""
        from torch.autograd import DeviceType

        base = super().stop(window_s, launches)
        program = _flush()
        names = {s["name"] for s in (program or {}).get("spans", [])}
        events = self._prof.profiler.kineto_results.events()
        host_names = {ev.name() for ev in events
                      if ev.device_type() == DeviceType.CPU}
        spans, calls, kernels, corr = [], {}, [], []
        for ev in events:
            kind = (ev.activity_type() if hasattr(ev, "activity_type")
                    else "")
            name = ev.name()
            start, end = _ns(ev)
            if ev.device_type() == DeviceType.CPU:
                if name in names:
                    spans.append((name, start, end, ev.start_thread_id()))
                elif name.startswith(LAUNCH_PREFIXES):
                    calls[ev.correlation_id()] = (start,
                                                  ev.start_thread_id())
            elif name in host_names:
                continue
            elif kind in DEVICE_KINDS or not kind:
                kernels.append((name[:NAME_CHARS], start, end))
                corr.append(ev.correlation_id())
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(TraceReading)}
        fields["kernels"] = kernels
        reading = SpanReading(**fields, spans=spans,
                              kernel_calls=[calls.get(c) for c in corr],
                              program=program)
        if self.before is not None:
            print("setup_spans: " + json.dumps(totals(self.before)),
                  file=sys.stderr)
        print_by_span(reading)
        return reading


class _Timeline:
    """The innermost of a thread's spans at any time: spans nest on one
    thread, so between two consecutive span boundaries one span (or none)
    is innermost."""

    def __init__(self, spans):
        self.cuts = sorted({t for _, s, e in spans for t in (s, e)})
        self.inner = []
        for a in self.cuts:
            best = None
            for sp in spans:
                _, s, e = sp
                if s <= a < e and (best is None or s > best[1]
                                   or (s == best[1] and e < best[2])):
                    best = sp
            self.inner.append(best)

    def at(self, t):
        """(name, start, end) of the innermost span open at ``t``, or
        None."""
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.inner[i] if i >= 0 else None


def _timelines(spans) -> dict:
    per = collections.defaultdict(list)
    for name, s, e, tid in spans:
        per[tid].append((name, s, e))
    return {tid: _Timeline(v) for tid, v in per.items()}


def attribute(t: SpanReading) -> dict:
    """{"device_s", "device_ops", "idle_s", "gaps"}: each a Counter by
    span name of the device operations' summed time and number, and of the
    idle gaps' summed length and number."""
    lines = _timelines(t.spans)
    dev_s, dev_n = collections.Counter(), collections.Counter()
    for (_, s, e), call in zip(t.kernels, t.kernel_calls):
        if call is None:
            label = UNMATCHED
        else:
            line = lines.get(call[1])
            sp = line.at(call[0]) if line is not None else None
            label = sp[0] if sp is not None else OUTSIDE
        dev_s[label] += (e - s) / 1e9
        dev_n[label] += 1
    idle_s, gaps = collections.Counter(), collections.Counter()
    end = None
    for s, e in t.intervals():
        if end is not None and s > end:
            open_ = [sp for sp in (ln.at(end) for ln in lines.values())
                     if sp is not None]
            label = (max(open_, key=lambda sp: (sp[1], -sp[2]))[0]
                     if open_ else OUTSIDE)
            idle_s[label] += (s - end) / 1e9
            gaps[label] += 1
        end = e if end is None else max(end, e)
    return {"device_s": dev_s, "device_ops": dev_n, "idle_s": idle_s,
            "gaps": gaps}


def attribution(t):
    """``attribute(t)``, computed once per reading; None for a reading
    without the program's spans."""
    if not getattr(t, "spans", None):
        return None
    if getattr(t, "_attribution", None) is None:
        t._attribution = attribute(t)
    return t._attribution


def host_ms_per_launch(rec, name: str):
    """Host ms per traced launch or step inside the program's spans of
    ``name`` (the recorder's flush over the traced launches)."""
    t = rec.trace
    program = getattr(t, "program", None)
    if not program or not t.launches:
        return None
    ns = [s["end_ns"] - s["start_ns"] for s in program["spans"]
          if s["name"] == name]
    return sum(ns) / 1e6 / t.launches if ns else None


def by_span_table(t: SpanReading) -> list:
    """[[span, device ms per launch, device ops per launch, idle ms per
    launch, idle gaps per launch]], the most device time first."""
    a = attribute(t)
    n = max(t.launches, 1)
    names = sorted(set(a["device_s"]) | set(a["idle_s"]),
                   key=lambda k: -a["device_s"][k])
    return [[k, a["device_s"][k] * 1e3 / n, a["device_ops"][k] / n,
             a["idle_s"][k] * 1e3 / n, a["gaps"][k] / n] for k in names]


def print_by_span(t: SpanReading, file=None):
    file = file or sys.stderr
    rows = by_span_table(t)
    n = max(t.launches, 1)
    print(f"by span, per traced launch ({t.launches}; device "
          f"{t.device_s() * 1e3 / n:.3f} ms, of it {SEGMENT_KERNEL} "
          f"{t.device_s(match=SEGMENT_KERNEL) * 1e3 / n:.3f} ms; busy "
          f"{t.busy_s() * 1e3:.3f} of {t.window_s * 1e3:.3f} ms):",
          file=file)
    print(f"  {'span':<20} {'device ms':>10} {'ops':>9} {'idle ms':>10} "
          f"{'gaps':>9}", file=file)
    for k, d, n, i, g in rows:
        print(f"  {k:<20} {d:>10.3f} {n:>9.1f} {i:>10.3f} {g:>9.1f}",
              file=file)
    print("spans_by_span: " + json.dumps(rows), file=file, flush=True)
    lost = collections.Counter(
        n for (n, _, _), call in zip(t.kernels, t.kernel_calls)
        if call is None)
    if lost:
        print(f"device operations with no launch call in the trace: "
              f"{lost.most_common(5)}", file=file, flush=True)


def window_summary(flushed: dict, skip_roots: int = 0) -> dict:
    """Per launch of a flush's ``render.block`` roots after the first
    ``skip_roots``: the host ms inside each span name (median over the
    launches) and the median launch period (one root's start to the
    next's)."""
    spans = flushed["spans"]
    roots = _roots(spans)[skip_roots:]
    if len(roots) < 2:
        return {}
    keep = {r["id"] for r in roots}
    per = collections.defaultdict(lambda: collections.Counter())
    for s in spans:
        if s["root"] in keep:
            per[s["name"]][s["root"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    out = {name: statistics.median([c[r["id"]] for r in roots])
           for name, c in per.items()}
    out["launch_period_ms"] = statistics.median(
        (b["start_ns"] - a["start_ns"]) / 1e6
        for a, b in zip(roots, roots[1:]))
    out["launches"] = len(roots)
    return out


def _roots(spans):
    return sorted((s for s in spans if s["name"] == "render.block"
                   and s["parent"] is None), key=lambda s: s["start_ns"])


def totals(flushed: dict, before_ns: int | None = None) -> dict:
    """{name: [count, seconds]} of a flush's spans (that began before
    ``before_ns``), and its counters."""
    from offline_raytracer_tpu_torch.utils import profiling

    spans = [s for s in flushed["spans"]
             if before_ns is None or s["start_ns"] < before_ns]
    return {"spans": {k: [v["count"], v["seconds"]] for k, v in
                      profiling.span_totals(spans).items()},
            "counters": flushed["counters"]}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, out=sys.stdout, err=sys.stderr) -> dict:
    """One run of ``cell`` as ``harness.run`` makes it, with the program's
    recorder on throughout, ``SpanTracer`` in the loop's place and, in a
    traced run, the metrics of ``EXTRA`` read beside the cell's; then the
    set-up's and the window's spans on ``err``. Returns the result line."""
    from portbench import harness
    from offline_raytracer_tpu_torch.utils import profiling

    cell.per_layer = cell.per_layer + [
        {"name": n, "unit": u, "better": b, "source": src, "moves": m}
        for n, u, b, src, m, cells in EXTRA if cell.name in cells]
    loop = harness.loop_module(cell)
    original = loop.Tracer
    loop.Tracer = SpanTracer
    profiling.flush()
    profiling.enable()
    try:
        result = harness.run(cell.name, seed, seconds, trace, device,
                             t_start, cell=cell, out=out, err=err)
        rest = profiling.flush()
    finally:
        profiling.disable()
        loop.Tracer = original
    skip = 0
    if not trace:
        # set-up: everything before the window's first launch or step
        skip = int(cell.traffic.get("warmup_launches",
                                    cell.traffic.get("checked_steps", 0)))
        roots = _roots(rest["spans"])
        if len(roots) > skip:
            print("setup_spans: " + json.dumps(
                totals(rest, roots[skip]["start_ns"])), file=err)
    print("window_spans: " + json.dumps(window_summary(rest, skip)),
          file=err, flush=True)
    return result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from portbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    # through the module the metric readers import, not this __main__
    from portbench import spans

    spans.run(harness.find_cell(harness.bench_file(), a.workload), a.seed,
              a.seconds, bool(a.trace), "cuda", T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
