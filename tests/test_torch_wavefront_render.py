"""The port's render driver on the wavefront route: the route each config
and scene takes (the JAX package's ``render._paths_fn`` rules), renders
against the JAX package's render of the same config, the analytic golden,
and autograd gradients against ``jax.grad``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.config import RenderConfig as JaxConfig
from offline_raytracer_tpu.render import render_block_jit, render_image_jnp
from offline_raytracer_tpu.scene.build import SceneBuilder
from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch import render as port_render
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.models.scenes import analytic
from offline_raytracer_tpu_torch.ops import (
    mega, traverse, traverse_cull, traverse_packet)
from torch_port_cases import assert_close, jax_scene_arrays, mesh_recipe

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "analytic_24x24_16spp.npy")
SMALL = dict(width=16, height=16, spp=2, max_bounces=3, enable_dof=False)


def _crowd_recipe(B, n=130):
    """More spheres than the segment kernel's 128-entry table holds."""
    rs = np.random.RandomState(0)
    b = B()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_material(diffuse=(0.6, 0.3, 0.2), specular=(0.2, 0.2, 0.2))
    for _ in range(n):
        b.add_sphere(rs.uniform((-1.5, -1.5, 0.1), (1.5, 1.5, 1.2)), 0.08)
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    half = np.pi / 4
    b.set_camera((3.0, 0.0, 1.0), 0.5,
                 np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32))
    return b


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, recipe in (("mesh", mesh_recipe), ("crowd", _crowd_recipe)):
        js = recipe(SceneBuilder).build(16, 16)
        ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
        out[name] = (js, ts)
    return out


class Spy:
    """Counts calls of a module function, which keeps working."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


def _render_both(scenes, name, **kw):
    js, ts = scenes[name]
    ids = np.arange(16 * 16, dtype=np.int32)
    ref = np.asarray(render_block_jit(js, JaxConfig(**SMALL, **kw),
                                      jnp.asarray(ids), 0, 2))
    got = port_render.render_block(ts, RenderConfig(**SMALL, **kw),
                                   torch.from_numpy(ids), 0, 2).numpy()
    return ref, got


# the route each config takes: (scene, config, module and function that
# must be called, whether the segment route runs)
ROUTES = {
    "use_bvh-off": ("mesh", dict(use_bvh=False),
                    (port_render, "make_brute_trace_fn")),
    "over-tables-auto": ("crowd", {},
                         (port_render, "make_brute_trace_fn")),
    "traversal-cull": ("mesh", dict(traversal="cull"),
                       (traverse_cull, "bvh_hit_ts_cull")),
    "traversal-packet": ("mesh", dict(traversal="packet"),
                         (traverse_packet, "bvh_hit_ts_packet")),
    "traversal-jnp": ("mesh", dict(traversal="jnp"),
                      (traverse, "tri_hit_plain")),
    "use_pallas-off": ("mesh", dict(use_pallas=False),
                       (traverse, "tri_hit_plain")),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_renders_wavefront_like_jax(scenes, monkeypatch, route):
    """Each of these configs and scenes takes the wavefront route (never
    the segment route), through the expected query, and renders what the
    JAX package renders for the same config."""
    name, kw, (module, fn_name) = ROUTES[route]
    segment = Spy(monkeypatch, mega, "render_paths_mega")
    wavefront = Spy(monkeypatch, port_render, "trace_paths")
    query = Spy(monkeypatch, module, fn_name)
    ref, got = _render_both(scenes, name, **kw)
    assert segment.calls == 0
    assert wavefront.calls == 2                 # one per sample
    assert query.calls > 0
    assert ref.mean() > 0
    assert_close(ref, got)


def test_auto_route_takes_the_segment_kernel(scenes, monkeypatch):
    """A scene that fits the segment kernel's tables stays on it."""
    segment = Spy(monkeypatch, mega, "render_paths_mega")
    wavefront = Spy(monkeypatch, port_render, "trace_paths")
    port_render.render_block(scenes["mesh"][1], RenderConfig(**SMALL),
                             torch.arange(64, dtype=torch.int32), 0, 2)
    assert segment.calls == 2 and wavefront.calls == 0


@pytest.mark.parametrize("kw", [dict(traversal="cull"),
                                dict(use_pallas=False)])
def test_golden_analytic_wavefront(kw):
    """The JAX package's stored render (tests/test_integrator.py:45-55),
    through the wavefront route, at that test's tolerance."""
    cfg = RenderConfig(width=24, height=24, spp=16, seed=7, max_bounces=5,
                       enable_dof=False, **kw)
    img = port_render.render_image(analytic(24, 24, device="cpu"), cfg)
    np.testing.assert_allclose(img, np.load(GOLDEN), rtol=1e-4, atol=1e-6)


def test_gradient_matches_jax_grad_and_fd(analytic_scene):
    """d mean(image) / d (diffuse albedo scale), as
    tests/test_integrator.py:145-163: autograd vs jax.grad within rtol
    1e-3 (same paths, same estimator, float32 sums in another order), and
    vs central finite differences within that test's rtol 0.08."""
    kw = dict(spp=24, width=12, height=12, max_bounces=3, enable_dof=False,
              use_pallas=False)
    jcfg = JaxConfig(**kw)

    def jax_mean(s):
        m = analytic_scene.materials
        sc = analytic_scene.replace(materials=m.replace(diffuse=m.diffuse * s))
        return jnp.mean(render_image_jnp(sc, jcfg))

    g_ref = float(jax.grad(jax_mean)(jnp.float32(1.0)))

    ts = scene_from_arrays(jax_scene_arrays(analytic_scene), device="cpu")
    cfg = RenderConfig(**kw)

    def port_mean(s):
        m = dataclasses.replace(ts.materials, diffuse=ts.materials.diffuse * s)
        return port_render.render_image_diff(
            dataclasses.replace(ts, materials=m), cfg).mean()

    s = torch.tensor(1.0, requires_grad=True)
    port_mean(s).backward()
    g = float(s.grad)
    eps = 0.05
    with torch.no_grad():
        fd = (float(port_mean(torch.tensor(1 + eps)))
              - float(port_mean(torch.tensor(1 - eps)))) / (2 * eps)
    assert np.isfinite(g) and g > 0
    np.testing.assert_allclose(g, g_ref, rtol=1e-3)
    np.testing.assert_allclose(g, fd, rtol=0.08)
