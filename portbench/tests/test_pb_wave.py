"""The ``wavefront`` loop's cell (``rtiow_final.render``), cut to a
CPU-sized image, on the port's plain versions: whole runs, the control,
runs with the timed path broken, the route check and the hit roofline."""

import io
import json
import time

import pytest
import torch

from pb_cases import few_threads, tiny_cell  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.usefixtures("few_threads")
CELL = "rtiow_final.render"
SEED = 4242424242


def _cell():
    return tiny_cell(CELL, width=16, height=9)


def _run(cell, trace=False, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    harness.run(cell.name, SEED, seconds, trace, "cpu", time.perf_counter(),
                cell=cell, out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_wave_run(trace):
    cell = _cell()
    last, _ = _run(cell, trace)
    assert last["correct"] is True and last["attempted"] >= 1
    assert last["checks"]["path_mismatch_pct"]["value"] == 0.0
    if trace:
        # off the card only the program's counters read: no device trace
        assert set(last["metrics"]) == {"live_lane_pct.wave"}
        assert 0 < last["metrics"]["live_lane_pct.wave"]["value"] < 100
    else:
        assert set(last["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_wave_control_fails_the_limits():
    from portbench.control import control

    cell = _cell()
    for seed in (1, 2):
        c = control(CELL, seed, 4, "cpu", "bfloat16", cell=cell)
        assert any(c[k] > lim for k, lim in cell.limits.items()), c
    c = control(CELL, 1, 4, "cpu", "float32", cell=cell)
    assert all(c[k] == 0.0 for k in cell.limits)


@pytest.mark.parametrize("fault", ["no_sky", "sky_altered", "half"])
def test_broken_wave_is_not_correct(monkeypatch, fault):
    from offline_raytracer_tpu_torch import integrator, render

    original = integrator.sky_radiance
    if fault == "no_sky":
        monkeypatch.setattr(integrator, "sky_radiance",
                            lambda sky, d: 0.0 * original(sky, d))
    elif fault == "sky_altered":
        monkeypatch.setattr(integrator, "sky_radiance",
                            lambda sky, d: 1.01 * original(sky, d))
    else:
        stats = render.render_block_stats

        def half(scene, cfg, ids, s, n, tables=None):
            h = ids.shape[0] // 2
            out, alive = stats(scene, cfg, ids[:h], s, n, tables)
            rest = out.mean(0, keepdim=True).expand(ids.shape[0] - h, 3)
            return torch.cat([out, rest]), alive * 2
        monkeypatch.setattr(render, "render_block_stats", half)
    last, _ = _run(_cell())
    assert last["correct"] is False


def test_wave_route_check(monkeypatch):
    """A launch fails the run when it makes a segment launch or a
    ``wave.hit`` count other than one a bounce of every block; a scene
    the segment kernel hosts is no scene for this loop."""
    from offline_raytracer_tpu_torch import render
    from offline_raytracer_tpu_torch.ops import mega

    mod = harness.module("loops", "wavefront")
    spans = [{"name": "wave.hit"}] * 6 + [{"name": "wave.shade"}] * 6
    mod.hit_check({"spans": spans}, 6, "a launch")
    with pytest.raises(SystemExit, match="wave.hit"):
        mod.hit_check({"spans": spans[1:]}, 6, "a launch")
    cell = _cell()
    cell.config.pop("sky")
    cell.config["scene"] = cell.config["scene"][:20]
    with pytest.raises(SystemExit, match="segment kernel"):
        _run(cell)
    stats = render.render_block_stats

    def launching(*args, **kw):
        monkeypatch.setattr(mega, "KERNEL_LAUNCHES",
                            mega.KERNEL_LAUNCHES + 1)
        return stats(*args, **kw)

    monkeypatch.setattr(render, "render_block_stats", launching)
    with pytest.raises(SystemExit, match="route check"):
        _run(_cell())


def test_hit_roofline_reads_the_bound_over_the_spans_time():
    """32 bytes a live ray-bounce and 20 a sphere a query at 3.35 TB/s,
    over the device time of the operations launched in ``wave.hit``."""
    from portbench.roofline_wave import hit_bound_ms
    from portbench.spans import SpanReading

    reader = harness.reader("hit_roofline.wave")
    spans = [("wave.hit", 0, 1000, 7), ("wave.shade", 1000, 2000, 7)]
    t = SpanReading(
        kernels=[("k", 100, 100 + 10_000_000), ("s", 1500, 1600)],
        host=[], window_s=1.0, launches=1, spans=spans,
        kernel_calls=[(10, 7), (1200, 7)],
        program={"spans": [{"name": "wave.hit"}, {"name": "wave.hit"}],
                 "counters": {"wave.live": 1e6, "wave.lanes": 2e6}})
    rec = harness.Record(setup_s=1.0, window_s=1.0, attempted=1, spans={},
                         values={"spheres": 486}, trace=t)
    want = 100.0 * hit_bound_ms(1e6, 2, 486) / 10.0
    assert abs(reader(rec) - want) < 1e-12
    assert abs(hit_bound_ms(1e6, 2, 486)
               - (32e6 + 2 * 486 * 20) / 3.35e12 * 1e3) < 1e-15
    assert harness.reader("live_lane_pct.wave")(rec) == 50.0
    assert harness.reader("hit_device_ms.wave")(rec) == 10.0
    assert abs(harness.reader("shade_device_ms.wave")(rec) - 1e-4) < 1e-15
    plain = harness.Record(setup_s=1.0, window_s=1.0, attempted=1, spans={},
                           values={"spheres": 486})
    for name in ("hit_roofline.wave", "hit_device_ms.wave",
                 "shade_device_ms.wave", "live_lane_pct.wave"):
        assert harness.reader(name)(plain) is None
