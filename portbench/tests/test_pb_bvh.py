"""The ``wavefront_bvh`` loop's cell (``spd_tetra.render``), cut to a
CPU-sized image and size factor 2, on the port's plain versions: whole
runs, the control, runs with the timed path broken."""

import io
import json
import time

import pytest
import torch

from pb_cases import few_threads, tiny_cell  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.usefixtures("few_threads")
CELL = "spd_tetra.render"
SEED = 4242424242


def _cell():
    cell = tiny_cell(CELL, width=24, height=24)
    cell.config["spd_tetra"]["size_factor"] = 2
    return cell


def _run(cell, trace=False, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    harness.run(cell.name, SEED, seconds, trace, "cpu", time.perf_counter(),
                cell=cell, out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_bvh_run(trace):
    cell = _cell()
    last, _ = _run(cell, trace)
    assert last["correct"] is True and last["attempted"] >= 1
    assert last["checks"]["path_mismatch_pct"]["value"] == 0.0
    if trace:
        # off the card only the program's counters and the set-up's span
        # read: no device trace
        assert set(last["metrics"]) == {"live_lane_pct.wave",
                                        "scene_build_s"}
    else:
        assert set(last["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_bvh_control_fails_the_limits():
    from portbench.control import control

    cell = _cell()
    for seed in (1, 2):
        c = control(CELL, seed, 4, "cpu", "bfloat16", cell=cell)
        assert any(c[k] > lim for k, lim in cell.limits.items()), c
    c = control(CELL, 1, 4, "cpu", "float32", cell=cell)
    assert all(c[k] == 0.0 for k in cell.limits)


@pytest.mark.parametrize("fault", ["no_shadows", "sky_altered", "half"])
def test_broken_bvh_is_not_correct(monkeypatch, fault):
    from offline_raytracer_tpu_torch import integrator, render
    from offline_raytracer_tpu_torch.ops import traverse

    if fault == "no_shadows":
        occl = traverse.make_bvh_occlusion_fn

        def blind(*args, **kw):
            fn = occl(*args, **kw)
            return lambda ro, rd, tf: torch.zeros_like(fn(ro, rd, tf))
        monkeypatch.setattr(render, "make_bvh_occlusion_fn", blind)
    elif fault == "sky_altered":
        original = integrator.sky_radiance
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
    last, _ = _run(_cell(), seconds=1.0)
    assert last["correct"] is False
