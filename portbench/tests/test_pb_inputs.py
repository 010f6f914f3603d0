"""The benchmark's inputs: scene recipes, pixel order, ray count."""

import json
import os

import numpy as np
import pytest
import torch

from pb_cases import ROOT, tiny_cell
from portbench.inputs import recipe
from portbench.raycount import launch_rays

CONFIGS = os.path.join(ROOT, "portbench", "configs")


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_showcase_has_testscenes_counts():
    """SURVEY.md:339's testscene.scn: 9 boxes, 7 spheres, 15 cylinders,
    ~15 materials, 6 lights, 2 bunny.ply instances."""
    n = recipe.counts(recipe.calls(_config("showcase")["scene"]))
    assert (n["boxes"], n["spheres"], n["cylinders"], n["lights"],
            n["triangles"]) == (9, 7, 15, 6, 2 * 69451)
    assert 15 <= n["materials"] <= 17


def test_bunny_recipe_is_the_bunny_preset():
    """The bunny recipe makes the scene models.scenes.bunny_builder makes
    around the same stand-in mesh (chip_smoke.bunny_stand_in)."""
    from offline_raytracer_tpu_torch.models.scenes import bunny_builder
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder
    from offline_raytracer_tpu_torch.scene.types import float_leaves

    from portbench.inputs.procedural_mesh import procedural_mesh

    c = _config("bunny")
    for e in c["scene"]:
        if "mesh" in e:
            e["mesh"]["n_tris"] = 600
    v, f = procedural_mesh(600)
    want = bunny_builder(v * 0.075, f).build(32, 32, device="cpu")
    got = recipe.apply(SceneBuilder(), recipe.calls(c["scene"]),
                       c["camera"]).build(32, 32, device="cpu")
    for (pa, a), (pb, b) in zip(float_leaves(want), float_leaves(got)):
        assert pa == pb
        assert torch.equal(a, b), pa


@pytest.mark.parametrize("name", ["bunny", "showcase"])
def test_scene_fits_the_segment_kernel(name):
    """Each configuration, cut to a tiny mesh, builds on the CPU and takes
    the segment route; the reference's tables match the program's."""
    from offline_raytracer_tpu_torch.config import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder

    from portbench.reference.scene import SceneArrays

    cell = tiny_cell(f"{name}.render", n_tris=300)
    made = recipe.calls(cell.config["scene"])
    cfg = RenderConfig(**cell.config["render"])
    scene = recipe.apply(SceneBuilder(), made, cell.config["camera"]).build(
        cfg.width, cfg.height, device="cpu")
    assert mega.mega_ok(scene, cfg)
    consts, _ = mega.pack_consts(scene, cfg)
    ref = recipe.apply(SceneArrays(), made, cell.config["camera"]).build(
        cfg.width, cfg.height, "cpu")
    rows = [r for r in range(46) if r != 42]     # 42: the roughness row
    assert torch.equal(consts[rows], ref.consts[rows, :128])
    # the reference breaks triangle ties in the kernel's slot order
    T = ref.tri_order.shape[0]
    assert torch.equal(scene.tri_bvh.tri_index[:T].long(), ref.tri_order)


def test_tile_order_is_the_ports():
    from offline_raytracer_tpu_torch.render import tile_pixel_ids

    for w, h in ((512, 512), (1280, 720), (16, 16)):
        assert np.array_equal(recipe.tile_pixel_ids(w, h),
                              tile_pixel_ids(w, h))


def test_ray_count_is_exact_past_2_24():
    """A float32 sum of these rays would round (bench.py's fault); the
    count is exact in float64."""
    P = 921600
    alive = np.array([800000, 600001, 450003, 300007, 200011, 100013,
                      50017, 20019, 9001, 3001, 1001, 7], np.float64)
    rays = sum(launch_rays(P, alive, True) for _ in range(40))
    want = 40 * (P + int(alive.sum()) + P + int(alive[:-1].sum()))
    assert rays == want and rays > 2 ** 24
    assert launch_rays(P, alive, False) == P + int(alive.sum())
    f32 = np.float32(0)
    for _ in range(40):
        f32 = np.float32(f32 + np.float32(launch_rays(P, alive, True)))
    assert f32 != want
