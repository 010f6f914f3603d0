"""Inverse rendering: gradient descent through the path tracer
(counterpart of ``offline_raytracer_tpu/diff.py``).

Gradients flow through the detached-sampling estimator: hit search and
sampled directions are detached, geometry, BSDF and light terms attached,
so d(image)/d(Kd, Ks, Kt, ior, emit, sphere centers and radii, vertices)
is unbiased for continuous parameters; silhouette (visibility) gradients
are not modelled. On the segment route the gradient is the replay's
(``replay.py``). ``optimize`` checkpoints the params and the optimizer
state (``utils/checkpoint.py``) and resumes from the latest step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.render import render_block
from offline_raytracer_tpu_torch.scene.types import Scene
from offline_raytracer_tpu_torch.utils import checkpoint as ckpt

MAX_GRAD_NORM = 10.0


def material_params(scene: Scene) -> dict:
    """Default optimizable parameter set: diffuse albedo and emission."""
    return {"diffuse": scene.materials.diffuse, "emit": scene.materials.emit}


def apply_material_params(scene: Scene, p: dict) -> Scene:
    """Albedo clipped to [0, 1], emission to >= 0. ``torch.maximum`` and
    ``torch.minimum``, not ``torch.clamp``: at a tie they pass half the
    gradient, as ``jnp.clip`` and ``jnp.maximum`` do (``clamp`` passes all
    of it), and every non-emissive material has emission exactly 0."""
    zero = torch.zeros((), dtype=p["diffuse"].dtype, device=p["diffuse"].device)
    mats = dataclasses.replace(
        scene.materials,
        diffuse=torch.minimum(torch.maximum(p["diffuse"], zero), zero + 1.0),
        emit=torch.maximum(p["emit"], zero))
    return dataclasses.replace(scene, materials=mats)


def make_loss_fn(scene: Scene, cfg: RenderConfig, target, pixel_ids,
                 setter: Callable = apply_material_params):
    """L2 image loss as a function of a parameter dict."""

    def loss_fn(params, sample_lo=0):
        img = render_block(setter(scene, params), cfg, pixel_ids, sample_lo,
                           cfg.spp)
        return torch.mean((img - target) ** 2)

    return loss_fn


def _guard(grads):
    """optax.zero_nans, then optax.clip_by_global_norm(MAX_GRAD_NORM): a
    single pathological sample window must not poison the Adam state."""
    grads = [torch.where(torch.isnan(g), 0.0, g) for g in grads]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < MAX_GRAD_NORM, g, g / norm * MAX_GRAD_NORM)
            for g in grads]


def optimize(scene: Scene, cfg: RenderConfig, target, pixel_ids, params,
             setter: Callable = apply_material_params, steps: int = 100,
             lr: float = 5e-2, optimizer: Callable | None = None,
             verbose: bool = False, checkpoint_dir: str | None = None,
             checkpoint_every: int = 25):
    """Descent on the image loss. Step k renders sample window
    [k * spp, (k + 1) * spp), so the gradient noise is independent across
    steps. Returns (params, losses of the steps this call ran) with the
    params as detached tensors.

    ``optimizer``: a callable (list of parameter tensors) ->
    ``torch.optim.Optimizer``; by default Adam (optax's defaults: b1 0.9,
    b2 0.999, eps 1e-8) behind ``_guard``, the JAX default's NaN and norm
    guards (a given optimizer replaces the guards too, as in the JAX
    package).

    With ``checkpoint_dir``, the params and the optimizer state are saved
    every ``checkpoint_every`` steps and after the last, and a call finding
    a saved step there resumes from the latest one."""
    loss_fn = make_loss_fn(scene, cfg, target, pixel_ids, setter)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    leaves = list(params.values())
    if optimizer is None:
        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        opt = optimizer(leaves)

    start = 0
    if checkpoint_dir:
        latest = ckpt.latest_opt_step(checkpoint_dir)
        if latest is not None:
            saved, opt_state = ckpt.load_opt_state(checkpoint_dir, latest)
            with torch.no_grad():
                for name, x in params.items():
                    x.copy_(saved[name])
            opt.load_state_dict(opt_state)
            start = latest
            if verbose:
                print(f"resumed inverse rendering at step {start}")

    losses = []
    for k in range(start, steps):
        loss = loss_fn(params, k * cfg.spp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        if optimizer is None:
            grads = _guard(grads)
        for x, g in zip(leaves, grads):
            x.grad = g
        opt.step()
        losses.append(loss.item())
        if checkpoint_dir and ((k + 1) % checkpoint_every == 0
                               or k == steps - 1):
            ckpt.save_opt_state(checkpoint_dir, k + 1, params,
                                opt.state_dict())
        if verbose and (k % 10 == 0 or k == steps - 1):
            print(f"step {k:4d}  loss {losses[-1]:.6f}")
    return {k: v.detach() for k, v in params.items()}, losses
