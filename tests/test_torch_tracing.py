"""The port's span and counter recorder (``utils/profiling.py``) and the
spans and counters of the bounce loop, the replay, the scene build and the
collectives, on the CPU: off by default and recording nothing, a render
bitwise the same with it on, the span tree of one block, the live and lane
counters against the render's own alive counts, the spans inside
``torch.profiler``'s events of the same name, ``device_trace``'s
``spans.jsonl``, and the sharded render's gather spans and counters on two
gloo ranks."""

import dataclasses
import json

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig, diff
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.parallel import shard
from offline_raytracer_tpu_torch.render import render_block, render_block_stats
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import profiling
import torch_parallel_cases as C
from torch_port_cases import mesh_recipe

torch.set_num_threads(2)

CFG = RenderConfig(width=16, height=16, spp=1, max_bounces=5,
                   enable_dof=False)
N_PATHS = 200       # not a multiple of the segment block: pad lanes too


@pytest.fixture(scope="module")
def scene():
    return mesh_recipe(SceneBuilder, 576).build(16, 16, device="cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.flush()
    yield
    profiling.disable()
    profiling.flush()


def _ids():
    return torch.arange(N_PATHS, dtype=torch.int32)


def _by_id(spans):
    return {s["id"]: s for s in spans}


def test_off_records_nothing_and_renders_bitwise(scene):
    assert not profiling.enabled()
    with profiling.span("anything") as s:
        assert s is None
    profiling.count("anything", 3)
    off = render_block_stats(scene, CFG, _ids(), 0, 2)
    assert profiling.flush() == {"spans": [], "counters": {}}
    with profiling.recording() as rec:
        assert profiling.enabled() and rec is not None
        on = render_block_stats(scene, CFG, _ids(), 0, 2)
    assert not profiling.enabled()
    got = profiling.flush()
    assert got["spans"] and got["counters"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_span_tree_of_one_block(scene):
    """One ``render.block`` root; per segment of ``mega.segment_plan`` one
    ``mega.draws``, ``mega.lights`` (NEE on) and ``mega.segment`` under
    ``mega.paths``, and a ``mega.sort`` after each segment before
    ``sort_after``; every child inside its parent, one root id."""
    assert CFG.enable_nee and scene.n_lights > 0
    with torch.no_grad():
        tables = mega.prepare_tables(scene, CFG)
    with profiling.recording():
        render_block_stats(scene, CFG, _ids(), 0, 1, tables)
    spans = profiling.flush()["spans"]
    by_id = _by_id(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["render.block"]
    root = roots[0]
    for s in spans:
        assert s["root"] == root["id"]
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p[
                "end_ns"], (s["name"], p["name"])
    kids = {}
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        if s["parent"] is not None:
            kids.setdefault(by_id[s["parent"]]["name"], []).append(
                s["name"])
    assert kids["render.block"] == ["render.camera", "mega.paths"]
    segs, sort_after = mega.segment_plan(CFG)
    want = []
    for b, nf in segs:
        want += ["mega.draws", "mega.lights", "mega.segment"]
        if b + nf - 1 < sort_after:
            want.append("mega.sort")
    assert kids["mega.paths"] == want
    assert want.count("mega.sort") == sort_after


def test_live_and_lane_counters(scene):
    """``mega.live``: the ray-bounces live on entry that the render's alive
    counts give (every path into bounce 0, then those alive after each
    bounce but the last); ``mega.lanes``: sum of Rp * n_fused."""
    with profiling.recording():
        _, alive = render_block_stats(scene, CFG, _ids(), 0, 3)
    got = profiling.flush()["counters"]
    assert got["mega.live"] == 3 * N_PATHS + float(alive[:-1].sum())
    Rp = -(-N_PATHS // mega.BLOCK) * mega.BLOCK
    segs, _ = mega.segment_plan(CFG)
    assert got["mega.lanes"] == 3 * sum(Rp * nf for _, nf in segs)
    assert 0 < got["mega.live"] < got["mega.lanes"]


def test_spans_inside_profiler_events(scene):
    """Under ``torch.profiler`` each span is an event of the same name whose
    interval holds the recorder's, on one clock (2 ms allowed on the
    first event)."""
    with profiling.recording(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render_block_stats(scene, CFG, _ids(), 0, 1)
    spans = profiling.flush()["spans"]
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.activity_type() == "user_annotation":
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.end_ns()))
    first = min(s["start_ns"] for s in spans)
    names = {s["name"] for s in spans}
    assert {"render.block", "mega.segment", "mega.draws"} <= names
    for name in names:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in spans
                      if s["name"] == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (s, e), (ps, pe) in zip(mine, theirs):
            slack = 2_000_000 if s == first else 0
            assert ps <= s + slack and e <= pe + slack, (name, s - ps,
                                                         pe - e)


def _loss(scene, grad_mode):
    cfg = dataclasses.replace(CFG, grad_mode=grad_mode)
    p = {"diffuse": scene.materials.diffuse.clone().requires_grad_(True),
         "emit": scene.materials.emit.clone().requires_grad_(True)}
    target = torch.zeros((N_PATHS, 3))
    loss = diff.make_loss_fn(scene, cfg, target, _ids())(p)
    torch.autograd.grad(loss, [p["diffuse"]])


@pytest.mark.parametrize("grad_mode,want,absent", [
    ("replay-value", {"replay.records", "replay.forward"},
     {"replay.backward"}),
    ("kernel-value", {"replay.backward"},
     {"replay.records", "replay.forward"}),
])
def test_replay_spans(scene, grad_mode, want, absent):
    with profiling.recording():
        _loss(scene, grad_mode)
    spans = profiling.flush()["spans"]
    names = {s["name"] for s in spans}
    assert want <= names and not absent & names
    by_id = _by_id(spans)
    for s in spans:
        if s["name"] in ("replay.records", "replay.forward"):
            assert by_id[s["parent"]]["name"] == "render.block"
        if s["name"] == "replay.records":
            # the segment launches with records run inside it
            assert any(k["parent"] == s["id"] and k["name"] == "mega.paths"
                       for k in spans)


def test_scene_build_and_tables_spans():
    with profiling.recording():
        sc = mesh_recipe(SceneBuilder, 576).build(16, 16, device="cpu")
        mega.prepare_tables(sc, CFG)
    names = [s["name"] for s in profiling.flush()["spans"]]
    assert names == ["scene.build", "mega.tables"]


def test_device_trace_writes_spans_jsonl(scene, tmp_path):
    d = tmp_path / "trace"
    with profiling.device_trace(str(d)):
        assert profiling.enabled()
        render_block(scene, CFG, _ids(), 0, 1)
    assert not profiling.enabled()
    lines = [json.loads(x) for x in (d / "spans.jsonl").read_text(
    ).splitlines()]
    spans = [x for x in lines if "span" in x]
    counters = {x["counter"]: x["value"] for x in lines if "counter" in x}
    assert {"render.block", "mega.paths", "mega.segment"} <= {
        x["span"] for x in spans}
    for x in spans:
        assert {"id", "parent", "root", "start_ns", "end_ns"} <= set(x)
    assert counters["mega.lanes"] > 0 and counters["mega.live"] > 0
    trace = (d / "trace.json").read_text()
    for name in ("render.block", "mega.paths", "mega.segment",
                 "mega.draws"):
        assert f'"{name}"' in trace
    assert profiling.flush() == {"spans": [], "counters": {}}


def test_write_jsonl_and_totals(tmp_path):
    with profiling.recording():
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
        profiling.count("n", 2)
        profiling.count("n", torch.tensor([1.0, 2.0]))
        profiling.count("n", torch.tensor([3.0]))
    got = profiling.write_jsonl(str(tmp_path / "s.jsonl"))
    assert got["counters"] == {"n": 8.0}
    totals = profiling.span_totals(got["spans"])
    assert totals["a"]["count"] == 2 and totals["b"]["count"] == 2
    assert totals["a"]["seconds"] >= totals["b"]["seconds"] >= 0
    lines = (tmp_path / "s.jsonl").read_text().splitlines()
    assert len(lines) == 5
    roots = {json.loads(x)["root"] for x in lines[:4]}
    assert len(roots) == 2


def test_sharded_render_gather_spans_and_live(tmp_path):
    """On 2 gloo ranks: every rank's ``shard.all_gather`` span and
    ``shard.bytes`` (the gathered image's bytes), and its ``mega.live``
    equal to the ray-bounces its own block's alive counts give."""
    outs = shard.run_ranks(C.traced_sharded_render, 2, device="cpu",
                           init_method=f"file://{tmp_path / 'store'}",
                           timeout_s=60.0, deadline_s=240.0, threads=1)
    for o in outs:
        names = [s["name"] for s in o["spans"]]
        assert names.count("shard.all_gather") == 1
        assert "render.block" in names
        assert o["counters"]["shard.bytes"] == o["image_bytes"] == (
            256 * 3 * 4)
        assert o["counters"]["mega.live"] == o["paths"] + float(
            o["alive"][:-1].sum())


def _tetra_queries():
    """The wavefront's triangle queries of a size-factor-3 SPD tetra (the
    cull query's plain sweep on the CPU) and 300 camera rays, a third of
    them dead."""
    from offline_raytracer_tpu_torch.models import scenes
    from offline_raytracer_tpu_torch.ops import traverse
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.utils import rng

    cfg = CFG.replace(width=32, height=32, traversal="cull")
    sc = scenes.spd_tetra(32, 32, size_factor=3, device="cpu")
    ids = torch.arange(300, dtype=torch.int32) * 3
    keys = rng.pixel_sample_keys(rng.render_key(0, "cpu"), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(sc.camera, cfg, ids, keys)
    alive = torch.arange(300) % 3 != 0
    tf = torch.where(alive, 10.0, 0.0)
    return (traverse.make_bvh_trace_fn(sc, cfg),
            traverse.make_bvh_occlusion_fn(sc, cfg), ro.contiguous(),
            rd.contiguous(), alive, tf)


def test_triangle_query_spans_and_counters():
    """One ``traverse.closest`` span inside the closest-hit function, one
    ``traverse.any`` inside the occlusion function; ``traverse.rays``
    counts the lanes of both, ``traverse.live`` the live ones and
    ``traverse.hits`` the triangle hits."""
    trace, occluded, ro, rd, alive, tf = _tetra_queries()
    with profiling.recording():
        hit = trace(ro, rd, alive)
    got = profiling.flush()
    assert [s["name"] for s in got["spans"]] == ["traverse.closest"]
    c = got["counters"]
    assert c["traverse.rays"] == 300 and c["traverse.live"] == 200
    # the scene's one sphere, the light, is out of these rays' way
    assert c["traverse.hits"] == float((hit.valid & alive).sum()) > 0
    with profiling.recording():
        occ = occluded(ro, rd, tf)
    got = profiling.flush()
    assert [s["name"] for s in got["spans"]] == ["traverse.any"]
    assert got["counters"]["traverse.rays"] == 300
    assert got["counters"]["traverse.live"] == 200
    assert got["counters"]["traverse.hits"] == float(occ.sum()) > 0


def test_triangle_queries_record_nothing_off():
    """Off, the queries record nothing and answer bitwise as on."""
    trace, occluded, ro, rd, alive, tf = _tetra_queries()
    off = (trace(ro, rd, alive), occluded(ro, rd, tf))
    assert profiling.flush() == {"spans": [], "counters": {}}
    with profiling.recording():
        on = (trace(ro, rd, alive), occluded(ro, rd, tf))
    profiling.flush()
    for k in ("t", "normal", "mat", "valid"):
        assert torch.equal(getattr(off[0], k), getattr(on[0], k))
    assert torch.equal(off[1], on[1])
