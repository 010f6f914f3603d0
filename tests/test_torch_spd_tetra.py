"""Haines's SPD tetra on the port, on the CPU: the Sierpinski pyramid's
generator (``scene/procedural.py``) and the benchmark's frozen copy of it,
the ``spd_tetra`` preset against the configuration ``portbench/configs/
spd_tetra.json``, its route (the wavefront, the cull query), a small render
against the plain reference of the route (``portbench/reference/
wave_bvh.py``) with its bfloat16 control, the ``wavefront_bvh`` loop's
route check, and the triangle queries' roofline against ``chip_smoke``'s."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.models import scenes
from offline_raytracer_tpu_torch.ops import mega, traverse, traverse_cull
from offline_raytracer_tpu_torch.render import (
    render_block_stats, tile_pixel_ids)
from offline_raytracer_tpu_torch.scene.procedural import spd_tetra

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402

CELL = "spd_tetra.render"
# the small case: size factor 3 (256 triangles), 64x64, the cell's 8
# bounces and estimator settings
SMALL = dict(width=64, height=64)
SF_SMALL = 3


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def _config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "spd_tetra.json")) as f:
        return json.load(f)


def _tetra_corners(d):
    v, f = spd_tetra(d)
    return v.reshape(-1, 4, 3).astype(np.float64), v, f


@pytest.mark.parametrize("d", range(5))
def test_counts_edges_and_outward_winding(d):
    tets, v, f = _tetra_corners(d)
    assert tets.shape[0] == 4 ** d
    assert v.shape == (4 * 4 ** d, 3) and f.shape == (4 * 4 ** d, 3)
    assert v.dtype == np.float32 and f.dtype == np.int32
    edges = [np.linalg.norm(tets[:, i] - tets[:, j], axis=-1)
             for i in range(4) for j in range(i + 1, 4)]
    np.testing.assert_allclose(np.stack(edges), 2.0 / 2 ** d, rtol=1e-5)
    tri = v[f].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centre = np.repeat(tets.mean(1), 4, axis=0)
    assert (np.sum(n * (tri.mean(1) - centre), -1) > 0).all()
    # the root's base on z = 0 centred on the origin, its apex at
    # z = 2 sqrt(2/3)
    np.testing.assert_allclose(v.min(0), [-1.0, -1 / np.sqrt(3), 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(v.max(0), [1.0, 2 / np.sqrt(3),
                                          2 * np.sqrt(2 / 3)], atol=1e-6)


@pytest.mark.parametrize("d", range(5))
def test_no_two_faces_coincide(d):
    _, v, f = _tetra_corners(d)
    faces = {tuple(sorted(map(tuple, tri.tolist()))) for tri in v[f]}
    assert len(faces) == f.shape[0]


@pytest.mark.parametrize("d", [0, 2, 5])
def test_frozen_generator_equals_the_ports(d):
    from portbench.inputs.spd_tetra import spd_tetra as frozen

    for a, b in zip(spd_tetra(d), frozen(d)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_preset_is_the_configuration():
    """The preset's light, material, camera and sky are the
    configuration's, and its scene the loop's (the recipe's calls, then the
    mesh of its ``spd_tetra`` entry)."""
    from portbench.inputs import recipe
    from portbench.inputs.spd_tetra import mesh_call
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder

    c = _config()
    assert c["spd_tetra"] == {"size_factor": 8}
    assert c["sky"]["bottom"] == c["sky"]["top"] == list(scenes.SPD_SKY)
    made = recipe.calls(c["scene"]) + [mesh_call({"size_factor": SF_SMALL})]
    b = recipe.apply(SceneBuilder(), made, c["camera"])
    b.set_sky(**c["sky"])
    mine = b.build(32, 32, device="cpu")
    preset = scenes.spd_tetra(32, 32, size_factor=SF_SMALL, device="cpu")
    for name in ("camera", "materials", "spheres", "triangles", "lights",
                 "sky"):
        x, y = getattr(mine, name), getattr(preset, name)
        for k in x.__dataclass_fields__:
            assert torch.equal(getattr(x, k), getattr(y, k)), (name, k)
    assert preset.n_lights == 1 and preset.spheres.radius.shape[0] == 1


def test_preset_takes_the_wavefront_and_the_cull_query():
    scene = scenes.spd_tetra(device="cpu")
    cfg = RenderConfig(**_config()["render"])
    assert scene.triangles.mat.shape[0] == 262144
    assert not mega.mega_ok(scene, cfg)
    tables = traverse.tri_tables(scene.tri_bvh)
    assert tables.m_occ == 2048 and traverse_cull.cull_ok(tables)
    assert traverse.pick_tri_hit(tables, cfg) is (
        traverse_cull.bvh_hit_ts_cull)


def _small():
    cfg = RenderConfig(**{**_config()["render"], **SMALL})
    scene = scenes.spd_tetra(size_factor=SF_SMALL, device="cpu", **SMALL)
    return scene, cfg


def _reference(seed, precision):
    """The reference's radiance and alive counts of every pixel's sample
    ``seed``'s first path, from the configuration's own calls."""
    from portbench.inputs import recipe
    from portbench.inputs.spd_tetra import mesh_call
    from portbench.reference.paths import RefConfig
    from portbench.reference.wave_bvh import WaveBvhScene, trace

    c = _config()
    b = recipe.apply(WaveBvhScene(), recipe.calls(c["scene"]) + [
        mesh_call({"size_factor": SF_SMALL})], c["camera"])
    b.set_sky(**c["sky"])
    rcfg = RefConfig(**{k: v for k, v in {**c["render"], **SMALL}.items()
                        if k in RefConfig.__dataclass_fields__}, seed=seed)
    sc = b.build(rcfg.width, rcfg.height, "cpu")
    ids = torch.from_numpy(tile_pixel_ids(64, 64))
    return trace(sc, rcfg, ids, torch.zeros_like(ids), precision)


@pytest.fixture(scope="module")
def small_renders():
    scene, cfg = _small()
    ids = torch.from_numpy(tile_pixel_ids(64, 64))
    out = {}
    for seed in (3, 4242424242 % (1 << 32), 77):
        with torch.no_grad():
            out[seed] = render_block_stats(scene, cfg.replace(seed=seed), ids,
                                           0, 1)
    return out


@pytest.mark.parametrize("seed", [3, 4242424242 % (1 << 32), 77])
def test_small_render_agrees_path_by_path(small_renders, seed):
    """Every path's radiance within the cell's own tolerance
    (``check.path_mismatch_pct``: 1e-3 of the reference's plus 1e-5 in
    every channel), and the alive counts equal: both sides make the same
    float32 operations in the same order on the CPU (the port's plain
    sweep and the reference's brute force test a triangle alike), so
    every path takes the same turns and no rounding moves it."""
    rad, alive = small_renders[seed]
    ref_rad, ref_alive = _reference(seed, "float32")
    assert check.path_mismatch_pct(rad, ref_rad) == 0.0
    assert torch.equal(alive, ref_alive.float().sum(1))
    assert float(alive[0]) > 0.05 * 64 * 64     # the pyramid is in view
    assert (ref_rad > 0).any(-1).float().mean() > 0.5   # and the sky


@pytest.mark.parametrize("seed", [3, 77])
def test_bfloat16_control_fails_the_agreement(small_renders, seed):
    """The reference with its tables, rays, light samples and carried state
    in bfloat16 fails the comparison the float32 reference passes: more
    than the cell's 1% limit of paths differ."""
    rad, _ = small_renders[seed]
    ref_rad, _ = _reference(seed, "bfloat16")
    assert check.path_mismatch_pct(rad, ref_rad) > 10.0


def _tiny_cell():
    cell = harness.find_cell(harness.bench_file(), CELL)
    cell.config["render"].update(width=16, height=16)
    cell.config["spd_tetra"]["size_factor"] = 2
    return cell


def _run(cell):
    """A short run of ``cell``'s loop as ``harness.run`` makes it, without
    the result line (whose check of loaded modules the JAX package, which
    this suite imports, would fail): (record, the judged numbers)."""
    import time

    ctx = harness.Ctx(cell, 12345678901, 0.2, False, "cpu",
                      time.perf_counter())
    loop = harness.loop_module(cell).Loop(ctx)
    rec = loop.measure()
    loop.free()
    return rec, check.judge(loop.compare(), cell.limits)


def test_tiny_cell_runs_correct():
    rec, checks = _run(_tiny_cell())
    assert rec.attempted >= 1 and rec.values["rays"] > 0
    assert checks["path_mismatch_pct"]["value"] == 0.0
    assert all(c["value"] <= c["limit"] for c in checks.values())


@pytest.mark.parametrize("counter", ["mega", "traverse_packet"])
def test_route_check_refuses_segment_and_packet_launches(monkeypatch,
                                                          counter):
    from offline_raytracer_tpu_torch import render
    from offline_raytracer_tpu_torch.ops import traverse_packet

    mod = {"mega": mega, "traverse_packet": traverse_packet}[counter]
    stats = render.render_block_stats

    def launching(*args, **kw):
        monkeypatch.setattr(mod, "KERNEL_LAUNCHES", mod.KERNEL_LAUNCHES + 1)
        return stats(*args, **kw)

    monkeypatch.setattr(render, "render_block_stats", launching)
    with pytest.raises(SystemExit, match="route check"):
        _run(_tiny_cell())


def test_route_check_refuses_wrong_span_counts(monkeypatch):
    """One ``wave.hit``, ``traverse.closest`` and ``traverse.any`` span a
    bounce: a count off by one, or a program that records no triangle
    query spans (as before they existed), fails the run."""
    mod = harness.module("loops", "wavefront_bvh")
    names = ("wave.hit", "traverse.closest", "traverse.any")
    want = {n: 8 for n in names}
    spans = [{"name": n} for n in names for _ in range(8)]
    mod.span_check({"spans": spans}, want, "a launch")
    with pytest.raises(SystemExit, match="wave.hit"):
        mod.span_check({"spans": spans[1:]}, want, "a launch")
    with pytest.raises(SystemExit, match="traverse.any"):
        mod.span_check({"spans": spans[:16]}, want, "a launch")
    span = traverse.profiling.span
    monkeypatch.setattr(traverse.profiling, "span", lambda name: (
        traverse.profiling._NO_SPAN if name.startswith("traverse.")
        else span(name)))
    with pytest.raises(SystemExit, match="traverse.closest"):
        _run(_tiny_cell())


def test_roofline_matches_chip_smokes_query_bound():
    """``portbench/roofline_tri.queries_bound`` of one query from its
    lanes, live lanes, hits and table sizes is ``chip_smoke.query_bound``
    of the captured query, for the closest and the any-hit kind."""
    import chip_smoke

    from portbench.roofline_tri import queries_bound

    scene, cfg = _small()
    tables = traverse.tri_tables(scene.tri_bvh)
    loop = harness.module("loops", "wavefront_bvh")
    sizes = loop._table_sizes(scene.tri_bvh)
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.utils import rng

    ids = torch.from_numpy(tile_pixel_ids(64, 64))
    keys = rng.pixel_sample_keys(rng.render_key(0, "cpu"), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    ro, rd = ro.contiguous(), rd.contiguous()
    tf = torch.where(torch.arange(ro.shape[0]) % 3 == 0, 0.0, 10.0)
    for any_hit in (False, True):
        _, slot = traverse.tri_hit_plain(tables, ro, rd, cfg.t_min, tf,
                                         any_hit)
        hits = int((slot >= 0).sum())
        assert hits > 0
        live = int(traverse.live_rays(ro, tf, cfg.t_min).sum())
        want = chip_smoke.query_bound("traverse_cull",
                                      (tables, ro, rd, tf, any_hit),
                                      cfg.t_min, hits)
        got = queries_bound(1, ro.shape[0], live, hits, sizes)
        assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-12 * want[0]


def test_roofline_reader_reads_bound_over_the_kernel_time():
    from portbench.roofline_tri import queries_bound
    from portbench.spans import SpanReading

    sizes = {"leaf_bounds": 6 * 2048, "tri_lm": 12 * 262144,
             "sub": 2048 * 16 * 8, "n_leaves": 2048}
    t = SpanReading(
        kernels=[("void (anonymous namespace)::cull_kernel<16>(Params)", 0,
                  2_000_000), ("other", 0, 5_000_000)],
        host=[], window_s=1.0, launches=1, spans=[], kernel_calls=[],
        program={"spans": [{"name": "traverse.closest"},
                           {"name": "traverse.any"}],
                 "counters": {"traverse.rays": 2 * 262144.0,
                              "traverse.live": 3e5, "traverse.hits": 1e5}})
    rec = harness.Record(setup_s=1.0, window_s=1.0, attempted=1, spans={},
                         values={"tri_tables": sizes}, trace=t)
    want = 100.0 * queries_bound(2, 2 * 262144, 3e5, 1e5, sizes)[0] / 2.0
    assert abs(harness.reader("tri_roofline.bvh")(rec) - want) < 1e-9
    plain = harness.Record(setup_s=1.0, window_s=1.0, attempted=1, spans={},
                           values={"tri_tables": sizes})
    for name in ("tri_roofline.bvh", "tri_device_ms.bvh",
                 "occl_device_ms.bvh"):
        assert harness.reader(name)(plain) is None


def test_span_readers_count_the_spans_within():
    """``occl_device_ms.bvh`` counts what ``wave.occlusion`` and the
    ``traverse.any`` within it launched, ``tri_device_ms.bvh`` what
    ``traverse.closest`` launched; per traced launch."""
    from portbench.spans import SpanReading

    spans = [("wave.hit", 0, 100, 1), ("traverse.closest", 10, 50, 1),
             ("wave.shade", 100, 300, 1), ("wave.occlusion", 120, 200, 1),
             ("traverse.any", 130, 180, 1)]
    t = SpanReading(
        kernels=[("a", 0, 1_000_000), ("b", 0, 2_000_000),
                 ("c", 0, 4_000_000), ("d", 0, 8_000_000)],
        host=[], window_s=1.0, launches=2, spans=spans,
        kernel_calls=[(20, 1), (125, 1), (140, 1), (250, 1)], program={})
    rec = harness.Record(setup_s=1.0, window_s=1.0, attempted=1, spans={},
                         values={}, trace=t)
    assert harness.reader("tri_device_ms.bvh")(rec) == 0.5
    assert harness.reader("occl_device_ms.bvh")(rec) == 3.0
