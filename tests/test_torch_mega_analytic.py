"""Port's bounce loop (plain version) vs the JAX megakernel on analytic
primitives only: the sphere/box scene, and the scene with cylinders, a
box light and a cylinder light."""

import pytest
import torch

from torch_port_cases import analytic_recipe, check_mega, mega_case, shaped_recipe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def analytic_case():
    return mega_case(analytic_recipe, 1280)


@pytest.fixture(scope="module")
def shaped_case():
    return mega_case(shaped_recipe, 1280)


def test_mega_analytic_matches_jax(analytic_case):
    check_mega(analytic_case)


def test_mega_shaped_matches_jax(shaped_case):
    check_mega(shaped_case)


def test_mega_records_hit_analytic_ids(shaped_case):
    """The port's records use the MegaMeta id encoding: spheres, boxes,
    cylinders in that order, -1 for a miss."""
    ids = shaped_case["got"][1]
    assert ids.min() >= -1 and ids.max() < 1 + 2 + 3
    assert (ids[0] >= 0).any()
