"""Port's host scene code (builder, BVH, lights, camera) and the scene
bridge vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.config import RenderConfig as JaxConfig
from offline_raytracer_tpu.ops.camera import generate_rays as jax_rays
from offline_raytracer_tpu.ops.lights import sample_lights as jax_lights
from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu.utils import rng as jax_rng
from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.ops.lights import sample_lights
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import rng
from torch_port_cases import (
    analytic_recipe, assert_scenes_equal, jax_scene_arrays,
    light_kinds_recipe, mesh_recipe, port_leaf, shaped_recipe)

torch.set_num_threads(2)

RECIPES = {"analytic": analytic_recipe, "shaped": shaped_recipe,
           "mesh": mesh_recipe,
           "lights": lambda B: shaped_recipe(B, sphere_light=True),
           "tilted": light_kinds_recipe}


@pytest.fixture(scope="module")
def scenes():
    return {name: (r(JaxBuilder).build(64, 64),
                   r(SceneBuilder).build(64, 64, device="cpu"))
            for name, r in RECIPES.items()}


@pytest.mark.parametrize("name", ["analytic", "shaped", "mesh"])
def test_builder_matches_jax(scenes, name):
    js, ts = scenes[name]
    assert_scenes_equal(js, ts)
    if name == "mesh":
        assert ts.tri_bvh.m_occ >= 4


@pytest.mark.parametrize("name", ["analytic", "shaped", "mesh"])
def test_scene_from_arrays_is_exact(scenes, name):
    js, _ = scenes[name]
    arrays = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, device="cpu")
    for path, want in arrays.items():
        got = port_leaf(ts, path)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    if js.tri_bvh is not None:
        assert ts.tri_bvh.m_occ == js.tri_bvh.m_occ
        assert ts.tri_bvh.n_leaves == js.tri_bvh.n_leaves


def test_scene_from_arrays_rejects_unknown_leaf(scenes):
    arrays = jax_scene_arrays(scenes["analytic"][0])
    arrays[".materials.albedo"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        scene_from_arrays(arrays, device="cpu")


@pytest.mark.parametrize("dof", [False, True])
@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("disk", [False, True])
def test_generate_rays_matches_jax(scenes, dof, jitter, disk):
    js, ts = scenes["analytic"]
    kw = dict(width=64, height=48, enable_dof=dof, pixel_jitter=jitter,
              aperture_disk=disk)
    ids = np.random.RandomState(0).randint(0, 64 * 48, 3000).astype(np.int32)
    smp = np.full(3000, 3, np.int32)
    jk = jax_rng.pixel_sample_keys(jax_rng.render_key(5), jnp.asarray(ids),
                                   jnp.asarray(smp))
    tk = rng.pixel_sample_keys(rng.render_key(5), torch.from_numpy(ids),
                               torch.from_numpy(smp))
    jo, jd = jax_rays(js.camera, JaxConfig(**kw), jnp.asarray(ids), jk)
    to, td = generate_rays(ts.camera, RenderConfig(**kw),
                           torch.from_numpy(ids), tk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("recipe,seed,n", [("lights", 2, 4000),
                                            ("tilted", 5, 6000)])
def test_sample_lights_matches_jax(scenes, recipe, seed, n):
    """Sphere, cylinder and mesh (emissive box) lights; in "tilted" the
    cylinder's rotation is no permutation, so the port's rotation, summed
    in its fixed order, is held to the JAX einsum's rounding."""
    js, ts = scenes[recipe]
    assert sorted(ts.lights.kind.tolist()) == [0, 1, 2]
    if recipe == "tilted":
        assert ts.lights.kind.tolist() == [0, 1, 2]
        assert int((ts.lights.rot[1].abs() > 1e-3).sum()) > 3
    u = np.random.RandomState(seed).uniform(0, 1, (n, 4)).astype(np.float32)
    want = jax_lights(jnp.asarray(u), js.lights, js.materials.emit)
    got = sample_lights(torch.from_numpy(u), ts.lights, ts.materials.emit)
    for field in ("p", "normal", "emit", "pdf_area"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=1e-6, err_msg=field)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
