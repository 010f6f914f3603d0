"""The final scene of *Ray Tracing in One Weekend* as the benchmark makes it
(``portbench/inputs/rtiow.py``, ``portbench/configs/rtiow_final.json``):
seeded and reproducible, the book's counts and rules, one material a
sphere, the material mapping, and the camera of the book's lookfrom,
lookat, vup and vfov in the port's z-up frame."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.inputs import recipe, rtiow  # noqa: E402

SKIP_POINT = np.array([4.0, 0.0, 0.2])      # the book's (4, 0.2, 0)


def _config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "rtiow_final.json")) as f:
        return json.load(f)


def _spheres(entries):
    return [e["sphere"] for e in entries if "sphere" in e]


def test_configuration_holds_the_generators_scene():
    c = _config()
    seed = c["generator"]["rtiow_spheres"]["seed"]
    assert c["scene"] == rtiow.rtiow_spheres(seed)
    assert c["sky"] == rtiow.SKY
    assert c["reduced"] == ["spp"]
    n = recipe.counts(recipe.calls(c["scene"]))
    assert 485 <= n["spheres"] <= 488
    assert n["materials"] == n["spheres"] + 1       # and the default 0
    assert n["lights"] == n["boxes"] == n["cylinders"] == n["triangles"] == 0


@pytest.mark.parametrize("seed", [0, 1, 7, 2026, 4242424242])
def test_seeded_counts_and_rules(seed):
    a = rtiow.rtiow_spheres(seed)
    assert a == rtiow.rtiow_spheres(seed)
    assert a != rtiow.rtiow_spheres(seed + 1)
    # each sphere after a material entry of its own
    kinds = [next(iter(e)) for e in a]
    assert kinds == ["material", "sphere"] * (len(a) // 2)
    sph = _spheres(a)
    ground, grid, big = sph[0], sph[1:-3], sph[-3:]
    assert ground == {"center": [0.0, 0.0, -1000.0], "radius": 1000.0}
    assert [s["center"] for s in big] == [[0.0, 0.0, 1.0], [-4.0, 0.0, 1.0],
                                          [4.0, 0.0, 1.0]]
    assert all(s["radius"] == 1.0 for s in big)
    # the 22x22 grid less those within 0.9 of the skip point
    assert 477 <= len(grid) <= 484
    cells = set()
    for s in grid:
        x, y, z = s["center"]
        assert s["radius"] == 0.2 and z == 0.2
        a_, b_ = int(np.floor(x)), int(np.floor(-y))
        assert -11 <= a_ < 11 and -11 <= b_ < 11
        assert x - a_ <= 0.9 and -y - b_ <= 0.9
        cells.add((a_, b_))
        assert np.linalg.norm(np.array(s["center"]) - SKIP_POINT) > 0.9
    assert len(cells) == len(grid)


def test_material_shares_and_mapping():
    lam = met = gla = 0
    for seed in range(8):
        mats = [e["material"] for e in rtiow.rtiow_spheres(seed)
                if "material" in e][1:-3]
        for m in mats:
            if "transmission" in m:
                gla += 1
                assert m == {"specular": [0.04] * 3, "spec_exp": 19998.0,
                             "transmission": [1.0] * 3, "ior": 1.5}
            elif "specular" in m:
                met += 1
                alpha = np.sqrt(2.0 / (m["spec_exp"] + 2.0))
                assert 0.01 - 1e-9 <= alpha <= 0.5 + 1e-6
                assert all(0.5 <= k <= 1.0 for k in m["specular"])
            else:
                lam += 1
                assert all(0.0 <= k <= 1.0 for k in m["diffuse"])
    n = lam + met + gla
    assert abs(lam / n - 0.80) < 0.03
    assert abs(met / n - 0.15) < 0.03
    assert abs(gla / n - 0.05) < 0.02
    assert rtiow.spec_exp(0.0) == rtiow.spec_exp(0.01) == 19998.0
    assert np.isclose(np.sqrt(2.0 / (rtiow.spec_exp(0.3) + 2.0)), 0.3)


def test_camera_is_the_books():
    """make_camera's axes from the configuration: the view direction from
    lookfrom (13, -3, 2) to the origin, vup +z, height ratio tan(10
    degrees), aspect 1200 / 675."""
    from offline_raytracer_tpu_torch.ops.camera import make_camera

    c = _config()
    cam = make_camera(c["camera"]["p"], c["camera"]["height_ratio"],
                      c["camera"]["quat_xyzw"], 1200, 675)
    p = np.array([13.0, -3.0, 2.0])
    w = p / np.linalg.norm(p)
    u = np.cross([0.0, 0.0, 1.0], w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    h = np.tan(np.radians(10.0))
    np.testing.assert_allclose(cam.z_axis.numpy(), w, atol=1e-6)
    np.testing.assert_allclose(cam.y_axis.numpy(), h * v, atol=1e-6)
    np.testing.assert_allclose(cam.x_axis.numpy(), h * 1200 / 675 * u,
                               atol=1e-6)
    r = c["render"]
    assert (r["width"], r["height"], r["max_bounces"]) == (1200, 675, 50)
    assert r["russian_roulette"] == 1.0 and r["t_min"] == 0.001
    assert np.isclose(r["aperture_radius"], 10 * np.tan(np.radians(0.3)),
                      atol=1e-4)
    # the port's focal length with the configuration's anchor
    assert np.isclose(np.linalg.norm(p - [0, 0, r["focal_anchor_z"]]),
                      13.3417, atol=1e-4)
