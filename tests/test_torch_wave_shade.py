"""The gate of the wavefront shading kernel (``ops/wave_shade.py``), on the
CPU: ``integrator.trace_paths`` launches it only for the forward route on
the card, with no gradient wanted and no NEE. Here the CPU is made to pass
the device rule for the shading alone and the launch raises, so each case
shows whether the gate reaches the kernel; with the real device rule the
CPU never does. The kernel itself is held to the eager body on the card
(``tests/test_torch_wave_shade_cuda.py``)."""

import dataclasses

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig, integrator
from offline_raytracer_tpu_torch.ops import _kernels, mega, wave_shade
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import rng

torch.set_num_threads(2)

# looking at the origin from (13, -3, 2)
CAMERA = dict(p=(13.0, -3.0, 2.0), height_ratio=0.17632698070846498,
              quat_xyzw=(0.510703987704594, 0.4062714674654321,
                         0.4717136222053642, 0.5929681191194052))


class Engaged(Exception):
    """The shading kernel was launched."""


def _scene(sky=False, light=True):
    b = SceneBuilder()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -100.0), 100.0)
    b.add_material(specular=(0.04,) * 3, transmission=(1.0, 1.0, 1.0),
                   ior=1.5)
    b.add_sphere((0.0, 0.0, 1.0), 1.0)
    b.add_material(specular=(0.7, 0.6, 0.5), spec_exp=20.0)
    b.add_sphere((0.0, 2.5, 1.0), 1.0)
    if light:
        b.add_light_material((5.0, 5.0, 5.0))
        b.add_sphere((2.0, 2.0, 4.0), 0.5)
    if sky:
        b.set_sky((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    b.set_camera(**CAMERA)
    return b.build(32, 16, device="cpu")


def _cfg(**kw):
    base = dict(width=32, height=16, max_bounces=3, russian_roulette=1.0,
                enable_dof=False, t_min=0.001, seed=5)
    base.update(kw)
    return RenderConfig(**base)


def _rays(scene, cfg):
    ids = torch.arange(cfg.width * cfg.height, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    return ro, rd, keys


def _forward(scene, cfg, ro=None):
    r_ro, rd, keys = _rays(scene, cfg)
    return integrator.trace_paths(
        scene, cfg, integrator.make_brute_trace_fn(scene, cfg),
        r_ro if ro is None else ro, rd, keys)


def _with_grad_leaf(scene):
    albedo = scene.materials.diffuse.clone().requires_grad_(True)
    return albedo, dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=albedo))


def _refuse(*args, **kwargs):
    raise Engaged


@pytest.fixture
def card_rule(monkeypatch):
    """The CPU passes the device rule for the wavefront shading only; the
    kernel's tables and launch are stubs, the launch raising Engaged."""
    takes = _kernels.takes_kernel
    monkeypatch.setattr(
        _kernels, "takes_kernel",
        lambda dev, what: what == "wavefront shading" or takes(dev, what))
    monkeypatch.setattr(wave_shade, "shade_tables", lambda mats, sky: "t")
    monkeypatch.setattr(wave_shade, "shade_cuda", _refuse)


def test_cpu_never_launches(monkeypatch):
    """With the real device rule, CPU rays take the eager body."""
    monkeypatch.setattr(wave_shade, "shade_tables", _refuse)
    monkeypatch.setattr(wave_shade, "shade_cuda", _refuse)
    for scene, cfg in ((_scene(sky=True, light=False), _cfg()),
                       (_scene(), _cfg(enable_nee=False))):
        rad = _forward(scene, cfg)
        assert bool(torch.isfinite(rad).all()) and float(rad.sum()) > 0


ENGAGES = {
    "sky, no lights": lambda: (_scene(sky=True, light=False), _cfg()),
    "lights, NEE off": lambda: (_scene(), _cfg(enable_nee=False)),
    "a leaf wanting grad, grad mode off": lambda: (
        _with_grad_leaf(_scene())[1], _cfg(enable_nee=False)),
}


@pytest.mark.parametrize("name", list(ENGAGES))
def test_gate_engages(card_rule, name):
    scene, cfg = ENGAGES[name]()
    with torch.set_grad_enabled("grad mode off" not in name):
        with pytest.raises(Engaged):
            _forward(scene, cfg)


def test_gate_keeps_eager_with_nee(card_rule):
    rad = _forward(_scene(sky=True), _cfg(enable_nee=True))
    assert float(rad.sum()) > 0


@pytest.mark.parametrize("leaf", ["scene", "rays"])
def test_gate_keeps_eager_under_autograd(card_rule, leaf):
    scene, cfg = _scene(sky=True, light=False), _cfg()
    if leaf == "scene":
        albedo, scene = _with_grad_leaf(scene)
        rad = _forward(scene, cfg)
        (grad,) = torch.autograd.grad(rad.sum(), albedo)
    else:
        ro = _rays(scene, cfg)[0]
        ro = ro.contiguous().requires_grad_(True)
        rad = _forward(scene, cfg, ro=ro)
        (grad,) = torch.autograd.grad(rad.sum(), ro)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0


def test_gate_keeps_eager_in_the_replay(card_rule):
    scene, cfg = _scene(), _cfg(enable_nee=False)
    ro, rd, keys = _rays(scene, cfg)
    want, ids, vis, _ = mega.render_paths_mega(scene, cfg, ro, rd, keys,
                                               collect_records=True)
    got = integrator.trace_paths(scene, cfg, None, ro, rd, keys,
                                 replay=(ids, vis))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
