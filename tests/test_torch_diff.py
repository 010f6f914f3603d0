"""Differentiable renders on the port's segment route and inverse
rendering (``diff.py``), against the JAX package on the CPU: the route a
render takes under autograd, ``render_image_diff``'s gradient against
``jax.grad`` and finite differences, and ``diff.optimize`` against the JAX
``optimize``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu import diff as jax_diff
from offline_raytracer_tpu.config import RenderConfig as JaxConfig
from offline_raytracer_tpu.render import render_image_jnp
from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu_torch import RenderConfig, diff
from offline_raytracer_tpu_torch import render as port_render
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from torch_port_cases import analytic_recipe, jax_scene_arrays, mesh_recipe

torch.set_num_threads(2)

INV = dict(width=12, height=12, spp=8, max_bounces=3, enable_dof=False)
WRONG = (0.1, 0.8, 0.8)       # the corrupted sphere albedo (material 1)


class Spy:
    """Records the keyword arguments of each call of a module function,
    which keeps working."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        fn = getattr(module, name)

        def wrapped(*a, **k):
            self.calls.append(k)
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


def _with_diffuse(scene, kd):
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, diffuse=kd))


# (grad_mode, whether the albedo requires grad, torch.no_grad around the
# render) -> the route that must run
ROUTES = {
    "no-grad-inputs": ("kernel-value", False, False, None),
    "under-no_grad": ("kernel-value", True, True, None),
    "kernel-value": ("kernel-value", True, False, "mega_paths_diff"),
    "replay-value": ("replay-value", True, False, "replay_paths"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_render_block_route_under_autograd(monkeypatch, route):
    """A render with no gradient to take is the plain segment call (no
    records, no replay); a differentiated one takes the replay that
    grad_mode names, with records from one segment run per sample."""
    grad_mode, requires, no_grad, want = ROUTES[route]
    scene = mesh_recipe(SceneBuilder).build(16, 16, device="cpu")
    kd = scene.materials.diffuse.clone().requires_grad_(requires)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                       enable_dof=False, grad_mode=grad_mode)
    segment = Spy(monkeypatch, mega, "render_paths_mega")
    spies = {n: Spy(monkeypatch, port_render, n)
             for n in ("mega_paths_diff", "replay_paths", "trace_paths")}
    with torch.set_grad_enabled(not no_grad):
        out = port_render.render_block(_with_diffuse(scene, kd), cfg,
                                       torch.arange(256, dtype=torch.int32),
                                       0, 2)
    assert len(segment.calls) == 2                    # one per sample
    records = [k.get("collect_records", False) for k in segment.calls]
    assert records == [want is not None] * 2
    for name, spy in spies.items():
        assert len(spy.calls) == (2 if name == want else 0), name
    assert out.requires_grad == (want is not None)
    if want is not None:
        (g,) = torch.autograd.grad(out.mean(), kd)
        assert torch.isfinite(g).all() and g.abs().max() > 0


@functools.lru_cache(maxsize=None)
def _jax_albedo_grad():
    js = analytic_recipe(JaxBuilder).build(64, 64)
    jcfg = JaxConfig(spp=24, width=12, height=12, max_bounces=3,
                     enable_dof=False, use_pallas=False)

    def mean(s):
        m = js.materials
        return jnp.mean(render_image_jnp(
            js.replace(materials=m.replace(diffuse=m.diffuse * s)), jcfg))

    return float(jax.grad(mean)(jnp.float32(1.0))), js


@pytest.mark.parametrize("grad_mode", ["kernel-value", "replay-value"])
def test_render_image_diff_segment_route(monkeypatch, grad_mode):
    """d mean(image) / d(albedo scale) through the segment route, as
    tests/test_torch_wavefront_render.py's wavefront test: vs jax.grad of
    render_image_jnp within rtol 1e-3 (the same paths and estimator), and
    vs central finite differences of the port's own render within
    tests/test_integrator.py's rtol 0.08."""
    g_ref, js = _jax_albedo_grad()
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    cfg = RenderConfig(spp=24, width=12, height=12, max_bounces=3,
                       enable_dof=False, grad_mode=grad_mode)
    segment = Spy(monkeypatch, mega, "render_paths_mega")

    def mean(s):
        return port_render.render_image_diff(
            _with_diffuse(ts, ts.materials.diffuse * s), cfg).mean()

    s = torch.tensor(1.0, requires_grad=True)
    (g,) = torch.autograd.grad(mean(s), s)
    g = float(g)
    assert len(segment.calls) == 24
    eps = 0.05
    with torch.no_grad():
        fd = (float(mean(torch.tensor(1 + eps)))
              - float(mean(torch.tensor(1 - eps)))) / (2 * eps)
    assert np.isfinite(g) and g > 0
    np.testing.assert_allclose(g, g_ref, rtol=1e-3)
    np.testing.assert_allclose(g, fd, rtol=0.08)


@functools.lru_cache(maxsize=None)
def _port_optimize():
    ts = analytic_recipe(SceneBuilder).build(64, 64, device="cpu")
    cfg = RenderConfig(**INV)
    ids = torch.arange(144, dtype=torch.int32)
    target = port_render.render_block(ts, cfg, ids, 0, 8)
    wrong = ts.materials.diffuse.clone()
    wrong[1] = torch.tensor(WRONG)
    scene0 = _with_diffuse(ts, wrong)
    params, losses = diff.optimize(scene0, cfg, target, ids,
                                   diff.material_params(scene0), steps=12,
                                   lr=0.1)
    return params, losses, ts.materials.diffuse[1].numpy()


def test_optimize_recovers_albedo():
    """tests/test_integrator.py:166-190 on the segment route: 12 Adam steps
    at lr 0.1 bring the loss below 0.55x its start, and the recovered
    albedo is nearer the truth than the corrupted one."""
    params, losses, truth = _port_optimize()
    assert losses[-1] < losses[0] * 0.55, losses
    rec = params["diffuse"][1].numpy()
    assert np.abs(rec - truth).mean() < np.abs(np.array(WRONG) - truth).mean()


def test_optimize_tracks_jax():
    """The first 3 losses of the port's optimize match the JAX optimize on
    the same problem within rtol 1e-3: the same renders, gradients, guards
    and Adam rule (float32 sums in another order)."""
    js = analytic_recipe(JaxBuilder).build(64, 64)
    ids = jnp.arange(144, dtype=jnp.int32)
    jcfg = JaxConfig(**INV)
    target = jax_diff.render_block(js, jcfg, ids, 0, 8)
    scene0 = js.replace(materials=js.materials.replace(
        diffuse=js.materials.diffuse.at[1].set(jnp.array(WRONG))))
    _, ref = jax_diff.optimize(scene0, jcfg, target, ids,
                               jax_diff.material_params(scene0), steps=3,
                               lr=0.1)
    np.testing.assert_allclose(_port_optimize()[1][:3], ref, rtol=1e-3)


def test_apply_material_params_tie_gradient():
    """At the clip bounds (diffuse 0 and 1, emission 0) the gradient is
    jax.grad's 0.5, not torch.clamp's 1: every non-emissive material sits
    at emission 0."""
    d = np.array([[0.0, 0.5, 1.0]], np.float32)
    e = np.array([[0.0, 2.0, -1.0]], np.float32)
    js = analytic_recipe(JaxBuilder).build(8, 8)
    ts = analytic_recipe(SceneBuilder).build(8, 8, device="cpu")

    def jax_sum(p):
        m = jax_diff.apply_material_params(js, p).materials
        return jnp.sum(m.diffuse[:1]) + jnp.sum(m.emit[:1])

    ref = jax.grad(jax_sum)({"diffuse": jnp.asarray(d), "emit": jnp.asarray(e)})
    p = {"diffuse": torch.from_numpy(d).requires_grad_(True),
         "emit": torch.from_numpy(e).requires_grad_(True)}
    m = diff.apply_material_params(ts, p).materials
    got = torch.autograd.grad(m.diffuse[:1].sum() + m.emit[:1].sum(),
                              [p["diffuse"], p["emit"]])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref["diffuse"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref["emit"]))
    assert got[0][0, 0] == 0.5 and got[1][0, 0] == 0.5
