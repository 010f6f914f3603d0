"""Port's bounce loop (plain version) vs the JAX megakernel on a 576-
triangle mesh scene over 5 BVH leaves (triangle closest hit, shadow any-
hit, fused tail), and on a wavefront smaller than one pad block."""

import numpy as np
import pytest
import torch

from torch_port_cases import check_mega, mega_case, mesh_recipe, shaped_recipe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh_case():
    return mega_case(mesh_recipe, 1280)


@pytest.fixture(scope="module")
def small_case():
    return mega_case(shaped_recipe, 200)


def test_mega_mesh_matches_jax(mesh_case):
    check_mega(mesh_case)


def test_mega_mesh_hits_triangles(mesh_case):
    """Triangle slots (ids past the 4 analytic prims) are hit and
    recorded, and the shadow rays are occluded somewhere."""
    ids, vis = mesh_case["got"][1], mesh_case["got"][2]
    assert (ids >= 4).sum() > 50
    assert (vis[0] == 0).any()


def test_mega_small_wavefront_matches_jax(small_case):
    """R = 200 < one pad block: padding wider than the wavefront."""
    check_mega(small_case)
    assert small_case["got"][0].shape == (200, 3)
    assert np.isfinite(small_case["got"][0]).all()
