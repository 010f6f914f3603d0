"""Rays whose origin lies far out (2e7, beyond any parked-origin test) keep
their triangle hits on every route of the port, as in the JAX package.

The scene: a triangle 2e6 across under small random ones
(``torch_port_cases.far_origin_recipe``); the rays start 2e7 above it. The
JAX jnp walk (``ops/traverse.bvh_hit_ts``) is the reference. The port's
plain query, the cull and packet routes (their plain versions on the CPU),
the integrator's closest-hit function and the segment route must hit the
same slots, t within 1e-5 relative. Dead lanes are marked by
``t_far = 0`` only. The card's kernels take the same rays in
``tests/test_torch_traverse_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.ops.traverse import bvh_hit_ts
from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.ops import mega, traverse
from offline_raytracer_tpu_torch.utils import rng
from torch_port_cases import far_origin_recipe, far_origin_rays, jax_scene_arrays

T_MIN = 1e-6
INF = float("inf")
CFG = RenderConfig(width=64, height=64, spp=1, max_bounces=2,
                   enable_dof=False)


@pytest.fixture(scope="module")
def case():
    js = far_origin_recipe(JaxBuilder).build(64, 64)
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    ro, rd = far_origin_rays()
    t_ref, s_ref = bvh_hit_ts(js.tri_bvh, jnp.asarray(ro), jnp.asarray(rd),
                              T_MIN)
    return dict(ts=ts, tables=traverse.tri_tables(ts.tri_bvh),
                ro=torch.from_numpy(ro), rd=torch.from_numpy(rd),
                t_ref=np.asarray(t_ref), s_ref=np.asarray(s_ref))


def _check(case, t, s, live=None):
    t, s = np.asarray(t), np.asarray(s)
    want = case["s_ref"].copy()
    if live is not None:
        want[~live] = -1
    np.testing.assert_array_equal(s, want)
    hit = want >= 0
    np.testing.assert_allclose(t[hit], case["t_ref"][hit], rtol=1e-5)
    assert np.isinf(t[~hit]).all()


def test_jax_query_hits_the_far_triangle(case):
    """The reference: every downward ray hits the big triangle (original id
    0) at t ~ 2e7, every upward one misses."""
    s = case["s_ref"]
    down = np.ones(s.size, bool)
    down[::4] = False
    assert (s[down] >= 0).all() and (s[~down] == -1).all()
    ids = case["tables"].tri_index.numpy()[s[down]]
    assert (ids == 0).all()
    assert (case["t_ref"][down] > 1.9e7).all()


@pytest.mark.parametrize("route", ["plain", "jnp", "cull", "packet"])
def test_port_queries_hit_what_jax_hits(case, route):
    """The plain query, and each route's query with dead lanes marked by
    t_far = 0 (every 5th ray): the JAX slots and t on the live rays,
    misses on the dead."""
    tables, ro, rd = case["tables"], case["ro"], case["rd"]
    if route == "plain":
        _check(case, *traverse.tri_hit_plain(tables, ro, rd, T_MIN))
        return
    live = np.ones(ro.shape[0], bool)
    live[::5] = False
    cfg = CFG.replace(traversal=route)
    fn = traverse.pick_tri_hit(tables, cfg)
    tf = torch.where(torch.from_numpy(live), INF, 0.0)
    _check(case, *traverse.sorted_tri_hit(tables, fn, cfg, ro, rd, tf),
           live=live)


def test_closest_hit_function_keeps_far_hits(case):
    """The integrator's closest-hit function (``make_bvh_trace_fn``, cull
    route) with the alive mask: the JAX hits on live lanes, t within 1e-5
    relative; nothing on dead lanes."""
    live = np.ones(case["ro"].shape[0], bool)
    live[1::6] = False
    trace = traverse.make_bvh_trace_fn(case["ts"], CFG.replace(
        traversal="cull"))
    hit = trace(case["ro"], case["rd"], torch.from_numpy(live))
    want = (case["s_ref"] >= 0) & live
    np.testing.assert_array_equal(hit.valid.numpy(), want)
    np.testing.assert_allclose(hit.t.numpy()[want], case["t_ref"][want],
                               rtol=1e-5)


def test_segment_route_hits_the_far_triangle(case):
    """The segment route's bounce-0 records (plain version on the CPU) hold
    the JAX slots: hit id = tri_base + slot, -1 on a miss."""
    R = case["ro"].shape[0]
    ids = torch.arange(R, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(0), ids, torch.zeros_like(ids))
    _, rec, _, _ = mega.render_paths_mega(case["ts"], CFG, case["ro"],
                                          case["rd"], keys,
                                          collect_records=True)
    base = mega.prepare_tables(case["ts"], CFG).meta.tri_base
    s = case["s_ref"]
    np.testing.assert_array_equal(rec[0].numpy(),
                                  np.where(s >= 0, base + s, -1))
