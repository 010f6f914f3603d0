"""What the segment kernel's wrapper prepares on the host, checked on the
CPU: the lanes-per-ray rule, the kernel's leaf-major triangle table and
the BVH's sub-leaf boxes."""

import dataclasses

import pytest
import torch

from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.models.scenes import bunny_builder
from offline_raytracer_tpu_torch.ops import bvh as tbvh
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from torch_port_cases import (
    analytic_recipe, jax_scene_arrays, mesh_recipe, procedural_mesh,
    shaped_recipe)

# (rays, config) of the launches: chip_smoke.py's full-size sample, probe
# and gradient step (512x512, 8 bounces), and the tests' renders
SHAPES = [(512 * 512, dict(max_bounces=8)), (16384, dict(max_bounces=8)),
          (65536, dict(max_bounces=8)),
          (4096, dict(max_bounces=6, mega_sort_after=2)),
          (1280, dict(max_bounces=5)), (256, dict(max_bounces=3)),
          (256, dict(max_bounces=1))]


@pytest.mark.parametrize("rays,kw", SHAPES)
def test_group_rule_picks_an_allowed_size(rays, kw):
    cfg = RenderConfig(width=64, height=64, enable_dof=False, **kw)
    meta = mega.MegaMeta(1, 1, 0, 2, 1)
    Rp = -(-rays // mega.BLOCK) * mega.BLOCK
    picks = []
    for b, nf in mega.segment_plan(cfg)[0]:
        g = mega.group_size(mega.Segment.of(cfg, meta, b, nf), Rp)
        assert g in mega.GROUPS
        picks.append(g)
    # fewer rays expected alive never get fewer lanes each
    assert picks == sorted(picks)


def test_group_rule_fills_the_lanes():
    cfg = RenderConfig(enable_dof=False)
    meta = mega.MegaMeta(1, 1, 0, 2, 1)
    for Rp in (256, 4096, 1 << 18, 1 << 22):
        for b in range(8):
            g = mega.group_size(mega.Segment.of(cfg, meta, b, 1), Rp)
            live = max(Rp >> b, 1)
            assert live * g <= mega.GROUP_LANES or g == 1
            assert live * g * 2 > mega.GROUP_LANES or g == mega.GROUP_MAX


def _scenes():
    v, f = procedural_mesh(3000)
    return {"mesh": mesh_recipe(SceneBuilder).build(16, 16, device="cpu"),
            "bunny-like": bunny_builder(v * 0.075, f).build(16, 16,
                                                            device="cpu"),
            "shaped": shaped_recipe(SceneBuilder).build(16, 16, device="cpu"),
            "analytic": analytic_recipe(SceneBuilder).build(16, 16,
                                                            device="cpu")}


@pytest.mark.parametrize("name", ["mesh", "bunny-like", "shaped",
                                  "analytic"])
def test_leaf_major_table_maps_back_to_every_slot(name):
    """tri_lm[leaf, plane, lane] holds slot leaf*128 + lane's coefficient
    float4 [n cw] (plane 0), [s1 c1] (plane 1), [s2 c2] (plane 2),
    bit for bit."""
    t = mega.prepare_tables(_scenes()[name], RenderConfig(enable_dof=False))
    S = t.tri.shape[0]
    assert S % mega.LANE == 0
    assert t.tri_lm.shape == (S // mega.LANE, 3, mega.LANE, 4)
    assert t.tri_lm.is_contiguous() and t.tri_lm.dtype == torch.float32
    flat = t.tri_lm.reshape(-1, 4)          # the kernel's float4 index
    s = torch.arange(S)
    leaf, lane = s // mega.LANE, s % mega.LANE
    for plane, cols in ((0, slice(8, 12)), (1, slice(0, 4)),
                        (2, slice(4, 8))):
        got = flat[(leaf * 3 + plane) * mega.LANE + lane]
        assert torch.equal(got, t.tri[:, cols])
    assert t.meta.cols == max(t.meta.ns, t.meta.nb, t.meta.nc, t.meta.nm,
                              t.meta.nl, 1)


@pytest.mark.parametrize("name", ["mesh", "bunny-like"])
def test_sub_boxes_contain_their_triangles(name):
    """Every occupied slot's three vertices lie inside the sub-box of its
    run of SUB_TRIS slots; runs of padding slots have inverted boxes (the
    kernel's slab test rejects them)."""
    scene = _scenes()[name]
    t = mega.prepare_tables(scene, RenderConfig(enable_dof=False))
    bvh = scene.tri_bvh
    assert t.sub.shape == (t.tri.shape[0] // mega.LANE, tbvh.SUB, 8)
    box = t.sub.reshape(-1, 8).repeat_interleave(tbvh.SUB_TRIS, 0)
    ti = bvh.tri_index.long()
    occ = ti >= 0
    for v in (scene.triangles.v0, scene.triangles.v1, scene.triangles.v2):
        p = v[ti[occ]]
        assert (box[occ, 0:3] <= p).all() and (p <= box[occ, 3:6]).all()
    # a run with a triangle has a proper box, a run of padding none
    runs = occ.reshape(-1, tbvh.SUB_TRIS).any(1)
    sub = t.sub.reshape(-1, 8)
    assert (sub[runs, 0:3] <= sub[runs, 3:6]).all()
    assert (sub[~runs, 0] > sub[~runs, 3]).all()
    assert bool((~runs).any())            # the padded leaves are covered


def test_sub_boxes_come_from_the_bvh():
    """The kernel's sub-boxes are the BVH's, built with the tree: a scene
    whose vertices are moved without rebuilding the BVH keeps the boxes
    that agree with its planes and node boxes."""
    scene = _scenes()["mesh"]
    cfg = RenderConfig(enable_dof=False)
    t = mega.prepare_tables(scene, cfg)
    assert torch.equal(t.sub[..., :6], scene.tri_bvh.sub_bounds)
    assert (t.sub[..., 6:] == 0).all()
    tri = scene.triangles
    moved = dataclasses.replace(scene, triangles=dataclasses.replace(
        tri, v0=tri.v0 + 5.0, v1=tri.v1 + 5.0, v2=tri.v2 + 5.0))
    assert torch.equal(mega.prepare_tables(moved, cfg).sub, t.sub)


@pytest.mark.parametrize("n_tris", [576, 3000])
def test_converted_scene_has_the_builders_sub_boxes(n_tris):
    """A scene handed over from the JAX package gets, bit for bit, the
    sub-boxes the port's builder gives the same scene."""
    built = mesh_recipe(SceneBuilder, n_tris).build(16, 16, device="cpu")
    js = mesh_recipe(JaxBuilder, n_tris).build(16, 16)
    got = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    assert torch.equal(got.tri_bvh.sub_bounds, built.tri_bvh.sub_bounds)
