"""The port's wavefront integrator vs the JAX package's ``trace_paths`` on
the CPU: the same rays and keys through both, radiance within
``torch_port_cases.assert_close`` and alive counts equal. The port's
triangle queries run through the cull and packet wrappers, which on CPU
tensors take the plain dense sweep; the JAX package walks its BVH in jnp."""

import numpy as np
import pytest
import torch

from torch_port_cases import (
    analytic_recipe, assert_close, mesh_recipe, shaped_recipe,
    wavefront_case)

torch.set_num_threads(2)

CASES = {
    "analytic": (analytic_recipe, "cull", {}),
    "shaped": (shaped_recipe, "packet", {}),
    "mesh": (mesh_recipe, "cull", {}),
    "mesh-packet": (mesh_recipe, "packet", {}),
    "mesh-nee-off": (mesh_recipe, "cull", dict(enable_nee=False)),
    "mesh-mis-off": (mesh_recipe, "cull", dict(enable_mis=False)),
    "shaped-rr-quirk": (shaped_recipe, "cull",
                        dict(reference_rr_quirk=True, rr_start_bounce=1,
                             max_bounces=5)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_wavefront_matches_jax(name):
    recipe, traversal, kw = CASES[name]
    case = wavefront_case(recipe, 1280, traversal=traversal, **kw)
    (rad, counts), (t_rad, t_counts) = case["ref"], case["got"]
    assert t_rad.shape == rad.shape == (1280, 3)
    np.testing.assert_array_equal(t_counts, counts)
    assert counts[0] > 0 and rad.mean() > 0
    assert_close(rad, t_rad)
