"""Gradients of the port's segment route (``replay.mega_paths_diff``, the
kernel-value route, and ``replay.replay_paths``, the replay-value route)
against ``jax.grad`` of the JAX package's ``mega_paths_diff`` (megakernel
in interpret mode) and against the port's own wavefront autograd, on the
analytic and 576-triangle mesh scenes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.replay import mega_paths_diff as jax_diff
from offline_raytracer_tpu_torch.integrator import trace_paths
from offline_raytracer_tpu_torch.render import _trace_builder
from offline_raytracer_tpu_torch.replay import mega_paths_diff, replay_paths
from torch_port_cases import analytic_recipe, mesh_recipe, replay_case

torch.set_num_threads(2)

# (recipe, differentiated scene tensors as (table, field))
CASES = {
    "analytic": (analytic_recipe, [("materials", "diffuse"),
                                   ("spheres", "center")]),
    "mesh": (mesh_recipe, [("materials", "diffuse"), ("spheres", "center"),
                           ("triangles", "v0")]),
}


def _with(scene, fields, values, replace):
    for (table, name), v in zip(fields, values):
        scene = replace(scene, **{table: replace(getattr(scene, table),
                                                 **{name: v})})
    return scene


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name):
    """d mean(radiance) / d(scene tensors) through both grad modes vs
    jax.grad of the JAX mega_paths_diff, and vs the port's wavefront
    autograd, at tests/test_replay.py:98-101's rtol 2e-3 / atol 2e-4 (the
    same estimator on the same draws). The gradients must be nonzero."""
    recipe, fields = CASES[name]
    c = replay_case(recipe, 1024, records=False)
    js, jcfg = c["js"], c["jcfg"]

    def jax_loss(*vals):
        sc = _with(js, fields, vals, lambda x, **k: x.replace(**k))
        return jnp.mean(jax_diff(sc, jcfg, c["ro"], c["rd"], c["keys"],
                                 interpret=True))

    j_vals = [getattr(getattr(js, t), f) for t, f in fields]
    ref = jax.grad(jax_loss, argnums=tuple(range(len(fields))))(*j_vals)
    ref = [np.asarray(g) for g in ref]

    ts, cfg = c["ts"], c["cfg"]

    def wavefront(s, cfg_, ro, rd, k):
        trace_fn, occl_fn = _trace_builder(s, cfg_)
        return trace_paths(s, cfg_, trace_fn, ro, rd, k, occl_fn=occl_fn)

    routes = {"kernel-value": mega_paths_diff, "replay-value": replay_paths,
              "wavefront": wavefront}
    for route, fn in routes.items():
        vals = [getattr(getattr(ts, t), f).clone().requires_grad_(True)
                for t, f in fields]
        sc = _with(ts, fields, vals, dataclasses.replace)
        loss = fn(sc, cfg, c["t_ro"], c["t_rd"], c["tkeys"]).mean()
        grads = torch.autograd.grad(loss, vals)
        for (t, f), g, r in zip(fields, grads, ref):
            assert np.abs(r).max() > 1e-6, (t, f)
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-3, atol=2e-4,
                                       err_msg=f"{route} {t}.{f}")
