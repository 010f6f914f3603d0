"""The wavefront route's closest-sphere search on the CPU
(``intersect.sphere_sweep``, whose CUDA kernel is tested on the card by
``test_torch_sphere_sweep_cuda.py``): the plain route reads no
``alive`` mask and launches no kernel; it and ``Closest.consider_min``
pick the JAX package's winners; the CUDA wrapper's checks; and the contract
the kernel's dead-lane skip rests on: ``trace_paths`` reads no hit of a
dead lane, so answering dead lanes as misses (or as anything) leaves
every radiance and alive count bitwise as it was."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.integrator import (
    make_brute_trace_fn, trace_paths)
from offline_raytracer_tpu_torch.ops import intersect
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.scene.types import Spheres
from offline_raytracer_tpu_torch.utils import rng
import torch_sky_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

T_MIN = 0.001
SKY = dict(bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0), up=(0.0, 0.0, 1.0))


def _rtiow_builder():
    """The final scene of *Ray Tracing in One Weekend*, rebuilt from its
    generator (``portbench/inputs/rtiow.py``) with the configuration's
    camera and sky."""
    import json

    from portbench.inputs import recipe, rtiow

    with open(os.path.join(ROOT, "portbench", "configs",
                           "rtiow_final.json")) as f:
        c = json.load(f)
    entries = rtiow.rtiow_spheres(2026)
    b = recipe.apply(SceneBuilder(), recipe.calls(entries), c["camera"])
    b.set_sky(**c["sky"])
    return b, c


def _rtiow_spheres():
    b, _ = _rtiow_builder()
    sph = b.build(16, 9, device="cpu").spheres
    assert sph.radius.shape[0] == 486
    return sph


def _spheres(centers, radii):
    n = len(radii)
    return Spheres(center=torch.tensor(centers, dtype=torch.float32),
                   radius=torch.tensor(radii, dtype=torch.float32),
                   mat=torch.zeros(n, dtype=torch.int32))


def _unit(d):
    d = torch.as_tensor(np.asarray(d, np.float32))
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _case(name):
    """(spheres, ro, rd) of one named batch."""
    g = np.random.RandomState(7)
    if name == "inside":       # origins inside a sphere: the far root
        sph = _spheres([[0, 0, 0], [0.5, 0, 0], [5, 5, 5]], [1.0, 0.3, 2.0])
        ro = torch.from_numpy(g.uniform(-0.4, 0.4, (300, 3)).astype(
            np.float32))
        return sph, ro, _unit(g.normal(size=(300, 3)))
    if name == "grazing":      # rays tangent to the unit sphere, +- 1e-6
        sph = _spheres([[0, 0, 0]], [1.0])
        off = 1.0 + np.linspace(-1e-6, 1e-6, 301)
        ro = np.stack([np.full_like(off, -3.0), off, np.zeros_like(off)], 1)
        return sph, torch.from_numpy(ro.astype(np.float32)), _unit(
            np.tile([[1.0, 0.0, 0.0]], (301, 1)))
    if name == "at_t_min":     # the near root within a few t_min of 0
        sph = _spheres([[0, 0, 0], [3, 0, 0]], [1.0, 0.5])
        gap = T_MIN * np.linspace(0.0, 3.0, 301)
        ro = np.stack([-1.0 - gap, np.zeros_like(gap), np.zeros_like(gap)],
                      1)
        return sph, torch.from_numpy(ro.astype(np.float32)), _unit(
            np.tile([[1.0, 0.0, 0.0]], (301, 1)))
    if name == "all_miss":     # every ray points away from every sphere
        sph = _spheres([[0, 0, -5], [1, 1, -6], [-2, 0, -4]],
                       [1.0, 0.5, 0.7])
        ro = torch.from_numpy(g.uniform(-3, 3, (300, 3)).astype(np.float32))
        d = g.normal(size=(300, 3))
        d[:, 2] = np.abs(d[:, 2]) + 0.5
        return sph, ro, _unit(d)
    sph = _rtiow_spheres()
    if name == "one_sphere":   # N = 1: the ground of the final scene
        sph = dataclasses.replace(sph, center=sph.center[:1],
                                  radius=sph.radius[:1], mat=sph.mat[:1])
    b, c = _rtiow_builder()
    scene = b.build(48, 27, device="cpu")
    cfg = RenderConfig(**dict(c["render"], width=48, height=27))
    ids = torch.arange(48 * 27, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(3), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    # and bounce-like rays: from random sphere surfaces, random directions
    k = g.randint(0, sph.radius.shape[0], 400)
    d = _unit(g.normal(size=(400, 3)))
    o = sph.center[k] + d * sph.radius[k, None]
    d2 = _unit(g.normal(size=(400, 3)))
    return sph, torch.cat([ro, o]), torch.cat([rd, d2])


CASES = ["inside", "grazing", "at_t_min", "all_miss", "one_sphere",
         "rtiow"]


def _jax_sweep(sph, ro, rd):
    """The JAX package's sphere sweep of the same batch: (min t, argmin)."""
    import jax.numpy as jnp

    from offline_raytracer_tpu.ops import intersect as jax_I
    from offline_raytracer_tpu.scene.types import Spheres as JaxSpheres

    js = JaxSpheres(center=jnp.asarray(sph.center.numpy()),
                    radius=jnp.asarray(sph.radius.numpy()),
                    mat=jnp.asarray(sph.mat.numpy()))
    t_all = jax_I.sphere_ts(js, jnp.asarray(ro.numpy()),
                            jnp.asarray(rd.numpy()), T_MIN)
    return np.asarray(t_all.min(-1)), np.asarray(jnp.argmin(t_all, -1))


@pytest.mark.parametrize("name", CASES)
def test_plain_route_is_the_plain_sweep(name):
    """On CPU tensors the sweep picks the JAX package's winners, with its
    hits and misses and its distances, an int32 index, and reads no alive
    mask. The distances agree to rtol 1e-4, not bitwise: XLA may
    reassociate the 3-term sums, and on the final scene's ground, a sphere
    of radius 1000, ``c = |rel|^2 - r^2`` cancels ~1e6 down to ~1, so one
    ulp there moves t by up to ~3e-5 of itself."""
    sph, ro, rd = _case(name)
    want_t, want_i = _jax_sweep(sph, ro, rd)
    t, idx = intersect.sphere_sweep(sph, ro, rd, T_MIN)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    hit = np.isfinite(want_t)
    np.testing.assert_array_equal(torch.isfinite(t).numpy(), hit)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_allclose(t.numpy()[hit], want_t[hit], rtol=1e-4,
                               atol=1e-6)
    alive = torch.arange(ro.shape[0]) % 2 == 0
    t2, idx2 = intersect.sphere_sweep(sph, ro, rd, T_MIN, alive)
    assert torch.equal(t2.view(torch.int32), t.view(torch.int32))
    assert torch.equal(idx2, idx)
    hits = int(torch.isfinite(t).sum())
    if name == "all_miss":
        assert hits == 0 and (idx == 0).all()
    else:
        assert hits > 0


def test_cases_reach_their_edges():
    """The named batches hold what they are named for: origins inside
    (the far root wins), rays on both sides of grazing, near roots on
    both sides of t_min."""
    sph, ro, rd = _case("inside")
    t, idx = intersect.sphere_sweep(sph, ro, rd, T_MIN)
    # at most the unit sphere's far root, from |o| <= 0.4 * sqrt(3)
    assert torch.isfinite(t).all() and (t <= 1.0 + 0.4 * 3 ** 0.5).all()
    sph, ro, rd = _case("grazing")
    t, _ = intersect.sphere_sweep(sph, ro, rd, T_MIN)
    hit = torch.isfinite(t)
    assert 0 < int(hit.sum()) < ro.shape[0]
    sph, ro, rd = _case("at_t_min")
    t, _ = intersect.sphere_sweep(sph, ro, rd, T_MIN)
    near = -1.0 - ro[:, 0]
    assert bool((t[near < T_MIN] > 1.0).all())      # the far root
    assert bool((t[near > 1.01 * T_MIN] < 1.0).all())


def _spheres_and_boxes(B, kind):
    """A builder of the crowd (132 spheres, a floor box, a light) or of the
    final scene with a box across its ground."""
    if kind == "crowd":
        return torch_sky_cases._crowd(B)
    import json

    from portbench.inputs import recipe, rtiow

    with open(os.path.join(ROOT, "portbench", "configs",
                           "rtiow_final.json")) as f:
        c = json.load(f)
    b = recipe.apply(B(), recipe.calls(rtiow.rtiow_spheres(2026)),
                     c["camera"])
    b.add_material(diffuse=(0.4, 0.4, 0.4))
    b.add_box_minmax((-6.0, -0.5, -6.0), (6.0, 0.3, 6.0))
    return b


@pytest.mark.parametrize("kind", ["crowd", "rtiow_box"])
def test_consider_min_takes_the_winners_of_consider(kind):
    """The closest hit over spheres by ``consider_min`` of the sweep and
    boxes by ``consider`` picks the JAX package's winners (type, material,
    inside or not, hit or miss) at its distances, on camera rays and on
    rays leaving sphere surfaces."""
    import jax.numpy as jnp

    from offline_raytracer_tpu.ops import intersect as jax_I
    from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder

    ts = _spheres_and_boxes(SceneBuilder, kind).build(32, 18, device="cpu")
    js = _spheres_and_boxes(JaxBuilder, kind).build(32, 18)
    assert ts.spheres.radius.shape[0] > 100 and ts.boxes.mat.shape[0] == 1
    cfg = RenderConfig(width=32, height=18, use_bvh=False, t_min=T_MIN)
    ids = torch.arange(32 * 18, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(4), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(ts.camera, cfg, ids, keys)
    g = np.random.RandomState(11)
    sph = ts.spheres
    k = g.randint(0, sph.radius.shape[0], 400)
    d = _unit(g.normal(size=(400, 3)))
    ro = torch.cat([ro, sph.center[k] + d * sph.radius[k, None]])
    rd = torch.cat([rd, _unit(g.normal(size=(400, 3)))])
    ref = jax_I.closest_hit_bruteforce(js, jnp.asarray(ro.numpy()),
                                       jnp.asarray(rd.numpy()), T_MIN)
    got = intersect.closest_hit_bruteforce(ts, ro, rd, T_MIN)
    valid = np.asarray(ref.valid)
    assert 0.2 < valid.mean() < 1.0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_array_equal(got.inner.numpy(), np.asarray(ref.inner))
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5, atol=1e-6)
    box_mat = int(ts.boxes.mat[0])
    assert bool((got.mat[got.valid] == box_mat).any())
    assert bool((got.mat[got.valid] != box_mat).any())


def test_counters():
    """On the CPU each sweep, masked or not, is the plain
    ``sphere_ts(...).min(-1)`` bit for bit, and ``KERNEL_LAUNCHES`` stays
    put."""
    sph, ro, rd = _case("inside")
    before = intersect.KERNEL_LAUNCHES
    for n, alive in ((ro.shape[0], None),
                     (17, torch.ones(17, dtype=torch.bool))):
        t, idx = intersect.sphere_sweep(sph, ro[:n], rd[:n], T_MIN, alive)
        want_t, want_i = intersect.sphere_ts(sph, ro[:n], rd[:n],
                                             T_MIN).min(-1)
        assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
        assert torch.equal(idx, want_i.to(torch.int32))
    assert intersect.KERNEL_LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    sph, ro, rd = _case("inside")
    before = intersect.KERNEL_LAUNCHES
    with pytest.raises(ValueError):
        intersect.sphere_sweep_cuda(sph, ro, rd, T_MIN)
    assert intersect.KERNEL_LAUNCHES == before


def _bad_inputs():
    sph, ro, rd = _case("inside")
    alive = torch.ones(ro.shape[0], dtype=torch.bool)
    return {
        "float64 rays": (sph, ro.double(), rd, alive),
        "ray counts differ": (sph, ro, rd[:5], alive),
        "rays not (R, 3)": (sph, ro[:, :2].contiguous(), rd, alive),
        "radius not (N,)": (dataclasses.replace(
            sph, radius=sph.radius[:, None]), ro, rd, alive),
        "uint8 mask": (sph, ro, rd, alive.to(torch.uint8)),
        "short mask": (sph, ro, rd, alive[:3]),
        "empty table": (dataclasses.replace(
            sph, center=sph.center[:0], radius=sph.radius[:0]), ro, rd,
            alive),
    }


@pytest.mark.parametrize("what", list(_bad_inputs()))
def test_kernel_input_checks(what):
    """What the kernel does not take is refused before any launch."""
    sph, ro, rd, alive = _bad_inputs()[what]
    with pytest.raises(ValueError):
        intersect.sweep_inputs(sph, ro, rd, alive)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_inputs_are_made_contiguous(masked):
    """Strided operands reach the kernel contiguous, with their values: the
    camera's origins without depth of field are one point expanded over
    the rays (stride 0), as the wavefront's first bounce hands them on."""
    b, c = _rtiow_builder()
    scene = b.build(48, 27, device="cpu")
    cfg = RenderConfig(**dict(c["render"], width=48, height=27,
                              enable_dof=False))
    ids = torch.arange(48 * 27, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(3), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    assert ro.stride(0) == 0
    sph = scene.spheres
    sph = dataclasses.replace(sph, center=sph.center.t().contiguous().t())
    rd = rd.t().contiguous().t()
    m = ids % 3 == 0
    alive = torch.stack([m, ~m], 1)[:, 0] if masked else None   # stride 2
    assert alive is None or not alive.is_contiguous()
    got = intersect.sweep_inputs(sph, ro, rd, alive)
    want = (sph.center, sph.radius, ro, rd, alive)
    assert len(got) == 5
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.is_contiguous() and torch.equal(g, w)


# ---- the dead-lane contract ---------------------------------------------


def _scene(kind):
    if kind == "rtiow_sky":
        b, c = _rtiow_builder()
        return b.build(24, 14, device="cpu"), dict(c["render"], width=24,
                                                   height=14)
    b = torch_sky_cases._crowd(SceneBuilder)
    if kind == "crowd_sky":
        b.set_sky(**SKY)
    return b.build(16, 16, device="cpu"), dict(width=16, height=16,
                                              use_bvh=False, t_min=T_MIN)


def _masked_trace_fn(scene, cfg, dead):
    """The plain brute-force closest hit with every dead lane's hit
    replaced: by a miss (what the kernel answers), or by a made-up hit
    (t 0.5, a unit normal, the last material, valid) that a reader of dead
    lanes would see. The NEE shadow query passes no mask and is answered
    plainly. Also returns the count of lanes whose hit was replaced."""
    plain = make_brute_trace_fn(scene, cfg)
    replaced = [0]

    def trace(ro, rd, alive=None):
        hit = plain(ro, rd)
        if alive is None:
            return hit
        gone = ~alive
        replaced[0] += int(gone.sum())
        if dead == "miss":
            t, normal = intersect.INF, 0.0
            mat, valid = 0, False
        else:
            t, normal = 0.5, _unit([[0.0, 0.6, 0.8]])
            mat, valid = scene.materials.emit.shape[0] - 1, True
        return intersect.Hit(
            t=torch.where(gone, t, hit.t),
            normal=torch.where(gone[:, None], normal, hit.normal),
            mat=torch.where(gone, mat, hit.mat).to(hit.mat.dtype),
            inner=hit.inner & alive,
            valid=torch.where(gone, valid, hit.valid))

    return trace, replaced


@pytest.mark.parametrize("dead", ["miss", "made_up"])
@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("kind", ["rtiow_sky", "crowd", "crowd_sky"])
def test_no_hit_of_a_dead_lane_is_read(kind, nee, dead):
    """``trace_paths`` with the dead lanes' hits replaced gives the
    radiance and alive counts of the plain brute trace, bit for bit: the
    precondition of the kernel's dead-lane skip. With a sky and without,
    with NEE (a light in the crowd) and without."""
    scene, r = _scene(kind)
    cfg = RenderConfig(**dict(r, max_bounces=6, enable_nee=nee, seed=9))
    R = cfg.width * cfg.height
    ids = torch.arange(R, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    want = trace_paths(scene, cfg, make_brute_trace_fn(scene, cfg), ro, rd,
                       keys, collect_stats=True)
    trace, replaced = _masked_trace_fn(scene, cfg, dead)
    got = trace_paths(scene, cfg, trace, ro, rd, keys, collect_stats=True)
    assert replaced[0] > 0                      # some lane was dead
    assert float(want[1][-1]) < R and float(want[0].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
