"""Gradients of the segment route by path-replay backprop (counterpart of
``offline_raytracer_tpu/replay.py``).

The segment kernel (``ops/mega.py``, ``csrc/mega.cu``) has no backward. The
gradient is factored as in the JAX package:

- forward: the kernel traces the paths and records, per bounce, the
  discrete outcomes: the winning primitive id and the NEE visibility bit
  (``render_paths_mega(collect_records=True)``);
- backward: those records replay through ``integrator.trace_paths(replay=
  ...)``, which traverses nothing: each hit is recomputed attached from the
  known winner and the counter-based draws regenerate every sample, so
  autograd of the replay gives d(image)/d(scene, rays) for the paths the
  kernel traced, with visibility discontinuities detached.

``mega_paths_diff`` is the "kernel-value" route (value = the kernel's
radiance); ``replay_paths`` the "replay-value" route (value = the replay's
radiance, one autograd graph). Unlike the JAX ``custom_vjp``, the backward
here computes only the cotangents of inputs that require grad.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.integrator import trace_paths
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.scene.types import float_leaves, with_leaves
from offline_raytracer_tpu_torch.utils import profiling


class _MegaPaths(torch.autograd.Function):
    """Inputs: (scene, cfg, keys, tables, paths, ro, rd, *leaves), where
    ``leaves`` are the scene's float tensors at ``paths``."""

    @staticmethod
    def forward(ctx, scene, cfg, keys, tables, paths, ro, rd, *leaves):
        rad, ids, vis, _ = mega.render_paths_mega(
            scene, cfg, ro, rd, keys, collect_records=True, tables=tables)
        ctx.scene, ctx.cfg, ctx.paths = scene, cfg, paths
        ctx.save_for_backward(keys, ids, vis, ro, rd, *leaves)
        return rad

    @staticmethod
    def backward(ctx, grad_rad):
        keys, ids, vis, ro, rd, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        inputs = [x.detach().requires_grad_(n)
                  for x, n in zip([ro, rd, *leaves], need)]
        with torch.enable_grad(), profiling.span("replay.backward"):
            scene = with_leaves(ctx.scene, dict(zip(ctx.paths, inputs[2:])))
            rad = trace_paths(scene, ctx.cfg, None, inputs[0], inputs[1],
                              keys, replay=(ids, vis))
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(rad, wanted, grad_rad,
                                             allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if n else None for n in need)


def mega_paths_diff(scene, cfg, ro, rd, keys, tables=None):
    """Differentiable drop-in for ``integrator.trace_paths`` on the segment
    route: the value is the kernel's radiance (one set of segment launches
    with records), the gradient that of the replay of its records.
    ``tables``: ``mega.prepare_tables`` of the scene, built without grad."""
    if tables is None:
        with torch.no_grad():
            tables = mega.prepare_tables(scene, cfg)
    paths, leaves = zip(*float_leaves(scene))
    return _MegaPaths.apply(scene, cfg, keys, tables, paths, ro, rd, *leaves)


def replay_paths(scene, cfg, ro, rd, keys, tables=None):
    """Records from a kernel launch on the detached scene and rays, then
    the replay's radiance, attached to ``scene``, ``ro`` and ``rd``."""
    with torch.no_grad(), profiling.span("replay.records"):
        _, ids, vis, _ = mega.render_paths_mega(
            scene, cfg, ro, rd, keys, collect_records=True, tables=tables)
    with profiling.span("replay.forward"):
        return trace_paths(scene, cfg, None, ro, rd, keys,
                           replay=(ids, vis))
