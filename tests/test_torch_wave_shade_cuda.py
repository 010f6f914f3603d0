"""The shading kernel (``csrc/wave_shade.cu``) vs the eager shading body
(``integrator.shade_bounce``) on the card, bounce by bounce: the same
inputs give every lane's radiance, alive byte, origin, direction,
throughput and prev_pdf bit for bit, written to new planes and in place.
The scenes reach every branch: diffuse, GGX metal, dielectrics (refraction,
total internal reflection, a ray inside with Beer's law), a three-lobe
mixture, an emitter without NEE, a sky and none, Russian roulette with its
start bounce and the reference's quirk, roughness from the material and the
default, all-dead and all-live bounces. Then a full-size sample of the
final scene of *Ray Tracing in One Weekend* (810,000 paths, 50 bounces)
through both bodies, bitwise; the gate and the counters through the render
loop; the wrapper's refusals.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_wave_shade_cuda.py``.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig, integrator
from offline_raytracer_tpu_torch.ops import _kernels, wave_shade
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.ops.intersect import Hit
from offline_raytracer_tpu_torch.render import render_block_stats
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import profiling, rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PLANES = ("origin", "direction", "throughput", "radiance", "alive",
          "prev_pdf")
# the final scene's camera, looking at the origin from (13, -3, 2)
CAMERA = dict(p=(13.0, -3.0, 2.0), height_ratio=0.17632698070846498,
              quat_xyzw=(0.510703987704594, 0.4062714674654321,
                         0.4717136222053642, 0.5929681191194052))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _rtiow(dev, width=1200, height=675):
    from portbench.inputs import recipe

    with open(os.path.join(ROOT, "portbench", "configs",
                           "rtiow_final.json")) as f:
        c = json.load(f)
    b = recipe.apply(SceneBuilder(), recipe.calls(c["scene"]), c["camera"])
    b.set_sky(**c["sky"])
    r = dict(c["render"], width=width, height=height)
    return b.build(width, height, device=dev), RenderConfig(**r)


def _scene(dev, sky=True, light=False, enclosed=False):
    """Every material kind the BSDF has, around the final scene's view."""
    b = SceneBuilder()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1000.0), 1000.0)
    b.add_material(specular=(0.04,) * 3, transmission=(1.0, 1.0, 1.0),
                   ior=1.5, spec_exp=19998.0)            # clear glass
    b.add_sphere((0.0, 0.0, 1.0), 1.0)
    b.add_material(diffuse=(0.4, 0.2, 0.1))             # diffuse
    b.add_sphere((-4.0, 0.0, 1.0), 1.0)
    b.add_material(specular=(0.7, 0.6, 0.5), spec_exp=20.2)   # GGX metal
    b.add_sphere((4.0, 0.0, 1.0), 1.0)
    b.add_material(specular=(0.04,) * 3, transmission=(0.3, 0.7, 0.9),
                   ior=1.7, spec_exp=60.0)               # tinted: Beer's law
    b.add_sphere((2.0, -2.0, 0.6), 0.6)
    b.add_material(diffuse=(0.3, 0.3, 0.2), specular=(0.3, 0.3, 0.3),
                   transmission=(0.4, 0.4, 0.4), ior=1.3,
                   spec_exp=8.0)                         # three lobes
    b.add_sphere((-2.0, -2.0, 0.6), 0.6)
    if light:
        b.add_light_material((6.0, 5.0, 4.0))
        b.add_sphere((1.0, 2.5, 3.0), 0.8)
    if enclosed:
        b.add_material(diffuse=(0.6, 0.6, 0.6))
        b.add_sphere((0.0, 0.0, 0.0), 60.0)
    if sky:
        b.set_sky((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    b.set_camera(**CAMERA)
    return b.build(96, 64, device=dev)


def _cfg(**kw):
    base = dict(width=96, height=64, max_bounces=10, russian_roulette=1.0,
                enable_dof=False, enable_nee=False, t_min=0.001,
                roughness_from_material=True, seed=11)
    base.update(kw)
    return RenderConfig(**base)


def _start(scene, cfg, n, sample=0):
    dev = scene.device
    ids = torch.arange(n, dtype=torch.int32, device=dev) % (
        cfg.width * cfg.height)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, dev), ids,
                                 torch.full_like(ids, sample))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    f32 = dict(dtype=torch.float32, device=dev)
    return integrator.PathState(
        origin=ro, direction=rd, throughput=torch.ones((n, 3), **f32),
        radiance=torch.zeros((n, 3), **f32),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_pdf=torch.full((n,), -1.0, **f32), keys=keys)


def _planes(state):
    return tuple(getattr(state, p) for p in PLANES)


def _assert_same(got, want, what):
    for name, g, w in zip(PLANES, got, _planes(want)):
        g, w = g.contiguous(), w.contiguous()
        if name == "alive":
            differ = g != w
        else:
            differ = (g.view(torch.int32) != w.view(torch.int32))
            if differ.dim() == 2:
                differ = differ.any(-1)
        n = int(differ.sum())
        if n:
            i = int(differ.nonzero()[0, 0])
            raise AssertionError(f"{what}: {name} differs on {n} of "
                                 f"{differ.shape[0]} lanes; lane {i}: "
                                 f"{g[i].tolist()} vs {w[i].tolist()}")


def _shade_both(scene, cfg, tables, state, b, hit, what):
    """The eager body and the kernel (new planes, then in place on copies)
    on one bounce's inputs; the eager state out."""
    u8 = rng.bounce_uniforms(state.keys, b, 8)
    want = integrator.shade_bounce(
        scene, cfg, state, b, hit,
        integrator.surface_record(scene, cfg, u8, hit.mat))
    u = rng.uniform_planes(state.keys, b, 1, 8)
    before = wave_shade.KERNEL_LAUNCHES
    got = wave_shade.shade_cuda(tables, cfg, b, hit, _planes(state), u)
    _assert_same(got, want, f"{what}, bounce {b}")
    copies = tuple(x.contiguous().clone() for x in _planes(state))
    got = wave_shade.shade_cuda(tables, cfg, b, hit, copies, u,
                                in_place=True)
    assert all(g.data_ptr() == c.data_ptr() for g, c in zip(got, copies))
    _assert_same(got, want, f"{what}, bounce {b} in place")
    assert wave_shade.KERNEL_LAUNCHES == before + 2
    return want


def _hold(scene, cfg, n, what):
    """Shade cfg.max_bounces bounces of n paths through both bodies, the
    eager state carried on; the branch counts the bounces reached."""
    tables = wave_shade.shade_tables(scene.materials, scene.sky)
    trace = integrator.make_brute_trace_fn(scene, cfg)
    state = _start(scene, cfg, n)
    glass = (scene.materials.transmission.sum(-1) > 0)
    seen = dict.fromkeys(("all_live", "escaped", "emitter", "inside",
                          "refracted", "reflected_inside", "rr_killed"), 0)
    for b in range(cfg.max_bounces):
        hit = trace(state.origin, state.direction, state.alive)
        out = _shade_both(scene, cfg, tables, state, b, hit, what)
        live = state.alive
        m = hit.mat.long()
        hv = live & hit.valid
        cos_in = torch.sum(state.direction * hit.normal, -1)
        cos_out = torch.sum(out.direction * hit.normal, -1)
        inside = hv & glass[m] & (cos_in > 0)
        cont = out.alive
        seen["all_live"] += int(bool(live.all()) and bool(hit.valid.all()))
        seen["escaped"] += int((live & ~hit.valid).sum())
        seen["emitter"] += int((hv & scene.materials.is_light[m]).sum())
        seen["inside"] += int(inside.sum())
        seen["refracted"] += int((cont & glass[m]
                                  & (cos_in * cos_out > 0)).sum())
        seen["reflected_inside"] += int((cont & inside
                                         & (cos_out < 0)).sum())
        seen["rr_killed"] += int((hv & ~scene.materials.is_light[m]
                                  & ~cont).sum())
        state = out
    return seen, state


@pytest.mark.cuda
@pytest.mark.parametrize("rough_from_mat", [True, False])
def test_materials_under_a_sky(device, rough_from_mat):
    scene = _scene(device)
    cfg = _cfg(roughness_from_material=rough_from_mat)
    seen, _ = _hold(scene, cfg, 96 * 64 * 4, "sky")
    assert seen["escaped"] > 0 and seen["inside"] > 0
    assert seen["refracted"] > 0 and seen["reflected_inside"] > 0


@pytest.mark.cuda
def test_no_sky_and_an_emitter_without_nee(device):
    scene = _scene(device, sky=False, light=True)
    assert scene.n_lights > 0 and scene.sky is None
    seen, state = _hold(scene, _cfg(max_bounces=8), 96 * 64 * 4, "lit")
    assert seen["emitter"] > 0 and seen["escaped"] > 0
    assert float(state.radiance.sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("quirk", [False, True])
def test_russian_roulette(device, quirk):
    scene = _scene(device, light=True)
    cfg = _cfg(russian_roulette=0.7, rr_start_bounce=2,
               reference_rr_quirk=quirk, max_bounces=8)
    seen, _ = _hold(scene, cfg, 96 * 64 * 4, f"rr, quirk {quirk}")
    assert seen["rr_killed"] > 0 and seen["emitter"] > 0


@pytest.mark.cuda
def test_all_live_bounces(device):
    """Inside a closed sphere with no sky every ray hits: bounce 0 is live
    on every lane, and so is its hit."""
    scene = _scene(device, sky=False, enclosed=True)
    seen, _ = _hold(scene, _cfg(max_bounces=4), 65536, "enclosed")
    assert seen["all_live"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [1.0, 0.6])
def test_all_dead_bounce(device, rr):
    """Every lane dead on entry: parked, radiance and alive unchanged, the
    throughput divided by the survival probability where RR runs."""
    scene = _scene(device)
    cfg = _cfg(russian_roulette=rr)
    tables = wave_shade.shade_tables(scene.materials, scene.sky)
    trace = integrator.make_brute_trace_fn(scene, cfg)
    state = _start(scene, cfg, 20000)
    hit = trace(state.origin, state.direction, state.alive)
    state = _shade_both(scene, cfg, tables, state, 0, hit, "live")
    # a dead lane as trace_paths leaves it: parked, prev_pdf -1
    dead = dataclasses.replace(
        state, origin=torch.full_like(state.origin, integrator.PARK_ORIGIN),
        alive=torch.zeros_like(state.alive),
        prev_pdf=torch.full_like(state.prev_pdf, -1.0))
    hit = trace(dead.origin, dead.direction, dead.alive)
    out = _shade_both(scene, cfg, tables, dead, 3, hit, "dead")
    assert not bool(out.alive.any())
    assert torch.equal(out.radiance, dead.radiance)


@pytest.mark.cuda
def test_rtiow_full_sample_bitwise(device, monkeypatch):
    """One full-size sample of the final scene (810,000 paths, 50 bounces)
    through the kernel and through the eager body: radiance and the alive
    count of every bounce bit for bit; one launch a bounce."""
    scene, cfg = _rtiow(device)
    ids = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                       device=device)
    before = wave_shade.KERNEL_LAUNCHES
    got = render_block_stats(scene, cfg, ids, 5, 1)
    assert wave_shade.KERNEL_LAUNCHES == before + cfg.max_bounces
    takes = _kernels.takes_kernel
    monkeypatch.setattr(
        _kernels, "takes_kernel",
        lambda dev, what: what != "wavefront shading" and takes(dev, what))
    want = render_block_stats(scene, cfg, ids, 5, 1)
    assert wave_shade.KERNEL_LAUNCHES == before + cfg.max_bounces
    assert float(want[1][-1]) < float(want[1][0])
    differ = int((got[0].view(torch.int32) != want[0].view(torch.int32))
                 .any(-1).sum())
    assert differ == 0, f"{differ} of {ids.shape[0]} pixels differ"
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_gate_and_counters_through_the_render(device):
    """The wavefront render of the final scene takes the kernel on every
    bounce, and ``wave.shade_kernel`` counts every lane; a lit scene with
    NEE, and a render under autograd, keep the eager body."""
    scene, cfg = _rtiow(device, 64, 36)
    ids = torch.arange(64 * 36, dtype=torch.int32, device=device)
    before = wave_shade.KERNEL_LAUNCHES
    with profiling.recording() as rec:
        rec.flush()
        render_block_stats(scene, cfg, ids, 0, 1)
        counters = rec.flush()["counters"]
    assert wave_shade.KERNEL_LAUNCHES == before + cfg.max_bounces
    assert counters["wave.shade_kernel"] == counters["wave.lanes"]
    assert counters["wave.lanes"] == 64 * 36 * cfg.max_bounces

    lit = _scene(device, light=True)
    lcfg = _cfg(enable_nee=True, traversal="jnp", max_bounces=4)
    render_block_stats(lit, lcfg, ids, 0, 1)
    assert wave_shade.KERNEL_LAUNCHES == before + cfg.max_bounces

    albedo = scene.materials.diffuse.clone().requires_grad_(True)
    diff_scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=albedo))
    rad, _ = render_block_stats(diff_scene, cfg.replace(max_bounces=6), ids,
                                0, 1)
    rad.sum().backward()
    assert albedo.grad is not None and bool(torch.isfinite(albedo.grad).all())
    assert wave_shade.KERNEL_LAUNCHES == before + cfg.max_bounces


@pytest.mark.cuda
def test_wrapper_refuses(device):
    scene = _scene(device)
    cfg = _cfg()
    tables = wave_shade.shade_tables(scene.materials, scene.sky)
    state = _start(scene, cfg, 64)
    hit = integrator.make_brute_trace_fn(scene, cfg)(
        state.origin, state.direction, state.alive)
    u = rng.uniform_planes(state.keys, 0, 1, 8)
    planes = _planes(state)
    bad = [
        (hit, planes, u.T.contiguous()),
        (hit, (planes[0].double(),) + planes[1:], u),
        (hit, planes[:4] + (planes[4].to(torch.uint8),) + planes[5:], u),
        (hit, tuple(x.cpu() for x in planes), u),
        (Hit(t=hit.t, normal=hit.normal, mat=hit.mat.long(),
                        inner=hit.inner, valid=hit.valid), planes, u),
    ]
    for h, p, uu in bad:
        with pytest.raises(ValueError):
            wave_shade.shade_cuda(tables, cfg, 0, h, p, uu)
    with pytest.raises(ValueError):
        wave_shade.shade_tables(scene.materials.to("cpu"), None)
