"""The port's replay against the JAX package on the CPU, on the scene with
cylinders and box and cylinder lights, with and without the reference's
RR quirk (from RR start bounce 1, 5 bounces): the hit helpers and
``trace_paths(replay=...)`` fed the JAX megakernel's records (interpret
mode)."""

import functools

import pytest
import torch

from torch_port_cases import (
    check_hit_helpers, check_replay, replay_case, shaped_recipe)

torch.set_num_threads(2)

CASES = {"shaped": {},
         "shaped-rr-quirk": dict(reference_rr_quirk=True, rr_start_bounce=1,
                                 max_bounces=5)}


@functools.lru_cache(maxsize=None)
def case(name):
    return replay_case(shaped_recipe, 640, **CASES[name])


def test_hit_helpers_match_jax():
    check_hit_helpers(case("shaped"))


@pytest.mark.parametrize("name", list(CASES))
def test_replay_matches_jax(name):
    check_replay(case(name))
