"""The program's spans in a traced run (``portbench/spans.py``): device
operations and idle gaps put down to spans on synthetic readings, the
readers of ``spans.EXTRA`` on them, and tiny runs of each cell on the CPU
with the recorder on."""

import io
import json
import time

import pytest

from pb_cases import few_threads, tiny_cell  # noqa: F401
from portbench import harness, spans
from portbench.spans import OUTSIDE, UNMATCHED, SpanReading

SEED = 4242424242
MS = 1_000_000
# one launch's spans on thread 1 (ns): a block with a draw, a light sample
# and a segment inside the paths, then a sort; a span of thread 2 apart
SPANS = [
    ("render.block", 0, 100 * MS, 1),
    ("mega.paths", 5 * MS, 95 * MS, 1),
    ("mega.draws", 10 * MS, 30 * MS, 1),
    ("mega.lights", 30 * MS, 40 * MS, 1),
    ("mega.segment", 40 * MS, 45 * MS, 1),
    ("mega.sort", 50 * MS, 60 * MS, 1),
    ("replay.backward", 200 * MS, 300 * MS, 2),
]
# device operations: (name, start, end) and the launch call of each
KERNELS = [
    ("philox", 12 * MS, 14 * MS),        # launched in the draws
    ("gemv", 35 * MS, 39 * MS),           # in the lights
    ("mega_kernel", 41 * MS, 70 * MS),    # in the segment
    ("argsort", 71 * MS, 72 * MS),        # in the sort, run late
    ("sum", 96 * MS, 97 * MS),            # in the block, past the paths
    ("copy", 110 * MS, 111 * MS),         # outside every span
    ("lost", 112 * MS, 113 * MS),         # no launch call in the trace
    ("bwd", 210 * MS, 220 * MS),          # on the backward's thread
]
CALLS = [(11 * MS, 1), (31 * MS, 1), (41 * MS, 1), (55 * MS, 1),
         (96 * MS, 1), (105 * MS, 1), None, (205 * MS, 2)]


def _reading(**kw):
    base = dict(kernels=KERNELS, host=[], window_s=0.4, launches=2,
                spans=SPANS, kernel_calls=CALLS,
                program={"spans": [
                    {"name": n, "start_ns": s, "end_ns": e}
                    for n, s, e, _ in SPANS],
                    "counters": {"mega.live": 30.0, "mega.lanes": 120}})
    base.update(kw)
    return SpanReading(**base)


def _rec(t):
    return harness.Record(setup_s=1.0, window_s=t.window_s, attempted=2,
                          spans={}, values={}, trace=t)


def test_device_time_by_span_sums_to_the_total():
    t = _reading()
    a = spans.attribute(t)
    assert sum(a["device_s"].values()) == pytest.approx(t.device_s())
    assert sum(a["device_ops"].values()) == len(KERNELS)
    assert a["device_s"]["mega.draws"] == pytest.approx(0.002)
    assert a["device_s"]["mega.lights"] == pytest.approx(0.004)
    assert a["device_s"]["mega.segment"] == pytest.approx(0.029)
    assert a["device_s"]["mega.sort"] == pytest.approx(0.001)
    assert a["device_s"]["render.block"] == pytest.approx(0.001)
    assert a["device_s"][OUTSIDE] == pytest.approx(0.001)
    assert a["device_s"][UNMATCHED] == pytest.approx(0.001)
    assert a["device_s"]["replay.backward"] == pytest.approx(0.010)


def test_every_idle_gap_is_assigned_once():
    t = _reading()
    a = spans.attribute(t)
    ivs = t.intervals()
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    assert sum(a["gaps"].values()) == len(gaps) == 7
    assert sum(a["idle_s"].values()) == pytest.approx(sum(gaps) / 1e9)
    # gaps begin at 14 (draws), 39 (lights), 70 (segment's end: the
    # paths), 72 and 97 (paths, block), 111 and 113 (outside)
    assert a["gaps"]["mega.draws"] == 1
    assert a["idle_s"]["mega.draws"] == pytest.approx(0.021)
    assert a["gaps"]["mega.lights"] == 1
    assert a["gaps"]["mega.paths"] == 2
    assert a["gaps"]["render.block"] == 1
    assert a["gaps"][OUTSIDE] == 2


def test_innermost_span_wins_across_threads():
    """A gap that begins while two threads have spans open goes to the
    span that began last."""
    t = _reading(kernels=[("a", 0, 1 * MS), ("b", 9 * MS, 10 * MS)],
                 kernel_calls=[(0, 1), (0, 1)],
                 spans=[("render.block", 0, 10 * MS, 1),
                        ("replay.backward", 1 * MS, 3 * MS, 2)])
    assert spans.attribute(t)["idle_s"] == {"replay.backward": 0.008}


def test_readers_on_a_span_reading():
    rec = _rec(_reading())
    read = {n: harness.reader(n)(rec) for n, *_ in spans.EXTRA}
    assert read["host_issue_ms.render"] == pytest.approx(50.0)
    assert read["draws_host_ms.render"] == pytest.approx(10.0)
    assert read["sort_host_ms.render"] == pytest.approx(5.0)
    assert read["lights_device_ms.render"] == pytest.approx(2.0)
    assert read["idle_in_draws_pct.render"] == pytest.approx(100 * 0.021
                                                             / 0.4)
    assert read["live_lane_pct.render"] == pytest.approx(25.0)
    assert read["replay_host_ms.grad"] is None


def test_readers_read_nothing_on_the_loops_own_reading():
    from portbench.trace import TraceReading

    for t in (None, TraceReading(kernels=KERNELS, host=[], window_s=0.4,
                                 launches=2)):
        rec = _rec(t) if t is not None else harness.Record(
            setup_s=1.0, window_s=0.4, attempted=2, spans={}, values={})
        for n, *_ in spans.EXTRA:
            assert harness.reader(n)(rec) is None, n


def test_window_summary():
    flushed = {"spans": [], "counters": {}}
    for k in range(4):
        t0 = k * 100 * MS
        flushed["spans"] += [
            {"name": "render.block", "id": 10 * k + 1, "parent": None,
             "root": 10 * k + 1, "start_ns": t0, "end_ns": t0 + 60 * MS},
            {"name": "mega.draws", "id": 10 * k + 2, "parent": 10 * k + 1,
             "root": 10 * k + 1, "start_ns": t0 + 5 * MS,
             "end_ns": t0 + 15 * MS}]
    got = spans.window_summary(flushed, skip_roots=1)
    assert got == {"render.block": 60.0, "mega.draws": 10.0,
                   "launch_period_ms": 100.0, "launches": 3}
    assert spans.totals(flushed, 150 * MS)["spans"] == {
        "render.block": [2, 0.12], "mega.draws": [2, 0.02]}


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["bunny.render", "bunny.grad"])
def test_tiny_run_with_the_recorder(workload, trace, capfd):
    """A tiny run through ``spans.run``: correct, the cell's metrics and,
    traced, the span readers' that read on the CPU; the loop's tracer and
    the recorder are as they were after it."""
    from offline_raytracer_tpu_torch.utils import profiling

    cell = tiny_cell(workload)
    loop = harness.loop_module(cell)
    before = loop.Tracer
    out, err = io.StringIO(), io.StringIO()
    spans.run(cell, SEED, 0.5, trace, "cpu", time.perf_counter(), out=out,
              err=err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["correct"] is True
    assert loop.Tracer is before and not profiling.enabled()
    assert "window_spans: " in err.getvalue()
    if not trace:
        return
    names = set(last["metrics"])
    if workload == "bunny.render":
        # no device operations on the CPU: the device readers read nothing
        assert {"host_issue_ms.render", "draws_host_ms.render",
                "sort_host_ms.render", "live_lane_pct.render"} <= names
        m = last["metrics"]
        assert (m["draws_host_ms.render"]["value"]
                < m["host_issue_ms.render"]["value"])
        assert 0 < m["live_lane_pct.render"]["value"] < 100
    else:
        assert "replay_host_ms.grad" in names
    assert "by span, per traced launch" in capfd.readouterr().err
