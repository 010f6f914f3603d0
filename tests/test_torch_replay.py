"""The port's replay (path-replay backprop) against the JAX package on the
CPU, on the analytic and 576-triangle mesh scenes: the hit helpers and
``trace_paths(replay=...)`` fed the JAX megakernel's records (interpret
mode), so both sides replay the same winners and tie differences drop
out; the port's own kernel-side radiance against its replay; the tiered
replay against the full one. (``test_torch_replay_options.py`` has the
scene with cylinders and the RR quirk.)"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch.integrator import trace_paths
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.replay import replay_paths
from torch_port_cases import (
    analytic_recipe, check_hit_helpers, check_replay, mesh_recipe,
    replay_case)

torch.set_num_threads(2)

R = 640
RECIPES = {"analytic": analytic_recipe, "mesh": mesh_recipe}


@functools.lru_cache(maxsize=None)
def case(name):
    return replay_case(RECIPES[name], R)


@pytest.mark.parametrize("name", list(RECIPES))
def test_hit_helpers_match_jax(name):
    c = case(name)
    if name == "mesh":   # bounce 0 hits triangles
        ts = c["ts"]
        assert (c["t_ids"][0] >= ts.spheres.radius.shape[0]
                + ts.boxes.mat.shape[0]).any()
    check_hit_helpers(c)


# The hit records do not depend on NEE or MIS (only the visibility bits,
# which a replay without NEE does not read), so those cases replay the
# records of the default configuration.
@pytest.mark.parametrize("name,kw", [
    ("analytic", {}), ("mesh", {}), ("mesh", dict(enable_nee=False)),
    ("mesh", dict(enable_mis=False))],
    ids=["analytic", "mesh", "mesh-nee-off", "mesh-mis-off"])
def test_replay_matches_jax(name, kw):
    check_replay(case(name), **kw)


@pytest.mark.parametrize("name", list(RECIPES))
def test_kernel_radiance_matches_replay(name):
    """The port's segment radiance vs its replay of its own records, at
    tests/test_replay.py:56-72's bounds: the kernel shades at a triangle t
    with its low 7 mantissa bits cleared, the replay at the exact t."""
    c = case(name)
    args = (c["ts"], c["cfg"], c["t_ro"], c["t_rd"], c["tkeys"])
    a = mega.render_paths_mega(*args).numpy()
    b = replay_paths(*args).numpy()
    assert a.mean() > 0
    if name == "analytic":
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    d = np.abs(a - b)
    assert d.max() < 0.3
    assert (d > 1e-3).mean() < 0.002
    assert abs(a.mean() - b.mean()) < 2e-4


def test_tiered_replay_matches_full():
    """cfg.replay_tiers = ((2, 4), (4, 16)) as tests/test_replay.py:142-174:
    with the survivors within each tier's capacity, the compacted replay
    equals the full one in value (rtol 1e-6) and gradients (rtol 1e-4,
    atol 1e-4 for scatter-add reassociation on near-zero entries)."""
    c = case("mesh")
    cfg = c["cfg"].replace(max_bounces=6)
    ts, ro, rd, keys = c["ts"], c["t_ro"], c["t_rd"], c["tkeys"]
    _, ids, vis, _ = mega.render_paths_mega(ts, cfg, ro, rd, keys,
                                            collect_records=True)
    hits = (ids >= 0).sum(1).numpy()
    assert hits[1] <= R // 4 and 0 < hits[3] <= R // 16, hits

    def gradval(cfg_):
        kd = ts.materials.diffuse.clone().requires_grad_(True)
        v0 = ts.triangles.v0.clone().requires_grad_(True)
        sc = dataclasses.replace(
            ts, materials=dataclasses.replace(ts.materials, diffuse=kd),
            triangles=dataclasses.replace(ts.triangles, v0=v0))
        loss = trace_paths(sc, cfg_, None, ro, rd, keys,
                           replay=(ids, vis)).mean()
        return loss.item(), torch.autograd.grad(loss, (kd, v0))

    v1, g1 = gradval(cfg)
    v2, g2 = gradval(cfg.replace(replay_tiers=((2, 4), (4, 16))))
    np.testing.assert_allclose(v2, v1, rtol=1e-6)
    for a, b in zip(g1, g2):
        assert a.abs().max() > 0
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)
