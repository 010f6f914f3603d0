"""Whole runs of the benchmark's cells, cut to a CPU-sized image and mesh,
on the port's plain versions: the result line, the comparison, the
control, and runs with the timed path broken underneath."""

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from pb_cases import ROOT, few_threads, tiny_cell  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.usefixtures("few_threads")
WORKLOADS = ["bunny.render", "showcase.render", "bunny.grad"]
RENDERS = ["bunny.render", "showcase.render"]
SEED = 4242424242            # past 2**31, as the benchmark's seeds may be
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    harness.run(cell.name, SEED, seconds, trace, "cpu", time.perf_counter(),
                cell=cell, out=out, err=err)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run(workload, trace):
    cell = tiny_cell(workload)
    out, err = _run(cell, trace)
    last = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(last) == want
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert set(last["checks"]) == set(cell.limits)
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}
    # every compared number is also among the last lines of stderr
    tail = err.strip().splitlines()[-len(cell.limits):]
    assert sorted(ln.split(":")[0] for ln in tail) == sorted(
        f"check {k}" for k in cell.limits)
    chosen = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in chosen}
    assert set(last["metrics"]) <= names
    if not trace:
        assert set(last["metrics"]) == names
    for m in last["metrics"].values():
        assert m["value"] > 0
    # the plain versions agree with the reference to rounding
    checks = last["checks"]
    if "path_mismatch_pct" in checks:
        assert checks["path_mismatch_pct"]["value"] == 0.0
    else:
        assert max(c["value"] for c in checks.values()) < 1e-4


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "bunny.render", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    """The reference in bfloat16 in the program's place fails a limit on
    every seed; in float32 it reads 0 and 0."""
    from portbench.control import control

    cell = tiny_cell(workload)
    for seed in (1, 2, 3):
        c = control(workload, seed, 12, "cpu", "bfloat16", cell=cell)
        assert any(c[k] > lim for k, lim in cell.limits.items()), c
    c = control(workload, 1, 12, "cpu", "float32", cell=cell)
    assert all(c[k] == 0.0 for k in cell.limits)


def _unchanged(state, u, ls, tables, seg):
    """A segment that returns its state as it found it."""
    nf = seg.n_fused
    rad = torch.zeros((3 + 3 * nf, state.shape[1]), dtype=state.dtype)
    rad[3:3 + nf] = -1.0
    rad[3 + 2 * nf:] = state[10]
    return state.clone(), rad


def _altered(original):
    def seg_fn(state, u, ls, tables, seg):
        st, rad = original(state, u, ls, tables, seg)
        rad = rad.clone()
        rad[0:3] *= 1.01
        return st, rad
    return seg_fn


def _half(original):
    def stats(scene, cfg, ids, s, n, tables=None):
        h = ids.shape[0] // 2
        out, alive = original(scene, cfg, ids[:h], s, n, tables)
        rest = out.mean(0, keepdim=True).expand(ids.shape[0] - h, 3)
        return torch.cat([out, rest]), alive * 2
    return stats


def _half_block(original):
    """render_block over the first half of the pixels; the rest get the
    mean of that half."""
    def block(scene, cfg, ids, s, n, tables=None):
        h = ids.shape[0] // 2
        out = original(scene, cfg, ids[:h], s, n, tables)
        rest = out.mean(0, keepdim=True).expand(ids.shape[0] - h, 3)
        return torch.cat([out, rest])
    return block


def _scaled(original):
    def fn(*args, **kw):
        return original(*args, **kw) * 1.01
    return fn


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", RENDERS)
def test_broken_render_is_not_correct(monkeypatch, workload, fault):
    from offline_raytracer_tpu_torch import render
    from offline_raytracer_tpu_torch.ops import mega

    if fault == "unchanged":
        monkeypatch.setattr(mega, "mega_segment", _unchanged)
    elif fault == "altered":
        monkeypatch.setattr(mega, "mega_segment",
                            _altered(mega.mega_segment))
    else:
        monkeypatch.setattr(render, "render_block_stats",
                            _half(render.render_block_stats))
    out, _ = _run(tiny_cell(workload))
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    """The inverse-rendering cell: an optimizer step that leaves the
    parameters as they were; the loss over half the pixels, the rest given
    their mean; the replay's radiance altered where it is made."""
    from offline_raytracer_tpu_torch import diff, render

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "altered":
        monkeypatch.setattr(render, "replay_paths",
                            _scaled(render.replay_paths))
    else:
        monkeypatch.setattr(diff, "render_block",
                            _half_block(diff.render_block))
    out, _ = _run(tiny_cell("bunny.grad"))
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False


def test_route_check(monkeypatch):
    """A launch passes with exactly its segment launches and no traversal
    launch, and fails the run otherwise."""
    from offline_raytracer_tpu_torch.ops import mega, traverse_cull

    from portbench import common

    c0 = common.launch_counts()
    monkeypatch.setattr(mega, "KERNEL_LAUNCHES", mega.KERNEL_LAUNCHES + 4)
    common.route_check(c0, 4, "a launch")
    with pytest.raises(SystemExit):
        common.route_check(c0, 5, "a launch")
    monkeypatch.setattr(traverse_cull, "KERNEL_LAUNCHES",
                        traverse_cull.KERNEL_LAUNCHES + 1)
    with pytest.raises(SystemExit):
        common.route_check(c0, 4, "a launch")


def test_trace_check():
    """A traced run fails unless each traced segment launch reached the
    roofline's recorder and, on the card, shows in the trace under the
    kernel's name."""
    trace_check = harness.module("loops", "render").trace_check
    trace_check(12, None, 12)
    trace_check(12, 12, 12)
    with pytest.raises(SystemExit, match="recorded"):
        trace_check(11, 12, 12)
    with pytest.raises(SystemExit, match="mega_kernel"):
        trace_check(12, 0, 12)


def test_declared_metric_reading_nothing_fails():
    """On the card a metric declared for the cell that reads nothing fails
    the run; elsewhere it is left out of the line."""
    cell = tiny_cell("bunny.render")
    rec = harness.Record(setup_s=1.0, window_s=2.0, attempted=3, spans={},
                         values={})
    got = harness.read_metrics(cell.per_layer, rec, require=False)
    assert got == {}
    with pytest.raises(SystemExit, match="segment_ms.render"):
        harness.read_metrics(cell.per_layer, rec, require=True)
    e2e = harness.read_metrics(
        [m for m in cell.end_to_end if m["name"] == "setup_s"], rec, True)
    assert e2e == {"setup_s": {"value": 1.0, "unit": "s"}}


def test_every_traffic_names_a_loop_file():
    """A traffic file names a loop by its file, ``portbench/loops/``;
    each has its ``Loop`` and its ``control``; an unknown name fails."""
    traffic = os.path.join(ROOT, "portbench", "traffic")
    for f in sorted(os.listdir(traffic)):
        loop = harness.load_json(os.path.join(traffic, f))["loop"]
        mod = harness.module("loops", loop)
        assert callable(mod.Loop) and callable(mod.control)
    with pytest.raises(SystemExit, match="no file"):
        harness.module("loops", "no_such_loop")


@pytest.mark.parametrize("ray_batch", [100, 256])
def test_render_launch_in_ray_batch_blocks(monkeypatch, ray_batch):
    """A launch is one sample of every pixel in blocks of at most
    ``ray_batch`` paths, and compares as correct either way."""
    from offline_raytracer_tpu_torch import render

    sizes = []
    original = render.render_block_stats

    def counting(scene, cfg, ids, s, n, tables=None):
        sizes.append((s, ids.shape[0]))
        return original(scene, cfg, ids, s, n, tables)

    monkeypatch.setattr(render, "render_block_stats", counting)
    cell = tiny_cell("bunny.render")
    cell.config["render"]["ray_batch"] = ray_batch
    out, _ = _run(cell)
    last = json.loads(out.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["checks"]["path_mismatch_pct"]["value"] == 0.0
    want = [min(ray_batch, 256 - i) for i in range(0, 256, ray_batch)]
    launches = {}
    for s, n in sizes:
        launches.setdefault(s, []).append(n)
    assert len(launches) >= last["attempted"] >= 1
    assert all(v == want for v in launches.values())


def test_grad_setup_leaves_out_the_target(monkeypatch):
    """The reference's render of the target is the benchmark's input, not
    the program's set-up: its seconds are not in ``setup_s``."""
    cell = tiny_cell("bunny.grad")
    mod = harness.loop_module(cell)
    original = mod.inputs

    def slow(ctx, dev):
        time.sleep(2.0)
        return original(ctx, dev)

    monkeypatch.setattr(mod, "inputs", slow)
    t_start = time.perf_counter()
    ctx = harness.Ctx(cell, SEED, 0.3, False, "cpu", t_start)
    rec = mod.Loop(ctx).measure()
    elapsed = time.perf_counter() - t_start
    assert rec.spans["target_s"] >= 2.0
    assert abs(rec.setup_s + rec.spans["target_s"] + rec.window_s
               - elapsed) < 0.5
