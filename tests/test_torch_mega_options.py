"""Port's bounce loop (plain version) vs the JAX megakernel with NEE off
and with MIS off on the mesh scene."""

import pytest
import torch

from torch_port_cases import check_mega, mega_case, mesh_recipe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nee_off_case():
    return mega_case(mesh_recipe, 1280, enable_nee=False)


@pytest.fixture(scope="module")
def mis_off_case():
    return mega_case(mesh_recipe, 1280, enable_mis=False)


def test_mega_nee_off_matches_jax(nee_off_case):
    check_mega(nee_off_case)
    assert (nee_off_case["got"][2][0] == 1.0).all()   # no shadow tests


def test_mega_mis_off_matches_jax(mis_off_case):
    check_mega(mis_off_case)
