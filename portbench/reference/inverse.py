"""The reference's inverse-rendering steps.

What the port's ``diff.optimize`` does for one step, in plain PyTorch from
the reference's own scene (``reference/scene.py``) and tracer
(``reference/paths.trace_block`` with ``grad``, the path replay): the L2
image loss of one sample per pixel against the target, its gradients with
respect to the albedo, the emission and the mesh's first vertices, the
guards (NaNs to zero, then the gradients clipped to a global norm of
``MAX_GRAD_NORM``) and Adam on the albedo and the emission. Frozen from
``offline_raytracer_tpu_torch/diff.py`` at commit 7999567 (last changed in
2357c7e): ``apply_material_params``' clamps and ``_guard``; Adam with
optax's defaults as the port's ``optimize`` sets them.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.paths import _held, _rounder, trace_block

MAX_GRAD_NORM = 10.0
BETAS = (0.9, 0.999)
EPS = 1e-8


def clamped(p: dict) -> dict:
    """Albedo in [0, 1], emission >= 0, by maximum and minimum (half the
    gradient at a tie, as the port's setter passes)."""
    zero = torch.zeros((), dtype=p["diffuse"].dtype,
                       device=p["diffuse"].device)
    return {"diffuse": torch.minimum(torch.maximum(p["diffuse"], zero),
                                     zero + 1.0),
            "emit": torch.maximum(p["emit"], zero)}


def loss_and_grads(sc, cfg, params: dict, v0, pixel_ids, sample: int,
                   target, precision: str = "float32", block: int = 8192,
                   fault: str | None = None):
    """(loss, {name: gradient}) of the L2 loss of sample ``sample`` of
    ``pixel_ids`` against ``target`` (P, 3), for ``params`` (diffuse,
    emit) and ``v0``, traced ``block`` paths at a time.

    ``fault`` plants a fault, for the readings that limits are set
    against: "altered", the radiance scaled by 1.01 where it is made;
    "half", only the first half of the pixels traced, the rest given that
    half's mean radiance."""
    q = _rounder(precision)
    leaves = {**params, "v0": v0}
    leaves = {k: x.detach().requires_grad_(True) for k, x in leaves.items()}
    grads = {k: torch.zeros_like(x) for k, x in leaves.items()}
    loss = 0.0
    P = pixel_ids.shape[0]
    n = P * 3
    traced = P // 2 if fault == "half" else P
    rad_sum = 0.0
    for lo in range(0, traced, block):
        hi = min(traced, lo + block)
        pid = pixel_ids[lo:hi]
        with torch.enable_grad():
            mats = dict(sc.mats, **clamped(leaves))
            held = _held(dataclasses.replace(sc, mats=mats, v0=leaves["v0"]),
                         q)
            rad, _ = trace_block(held, cfg, pid, torch.full_like(pid, sample),
                                 q, grad=True)
            if fault == "altered":
                rad = rad * 1.01
            part = torch.sum((rad - target[lo:hi]) ** 2) / n
            got = torch.autograd.grad(part, list(leaves.values()),
                                      allow_unused=True)
        rad_sum = rad_sum + rad.detach().sum(0)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        loss += float(part.detach())
    if traced < P:
        mean = rad_sum / traced
        loss += float(torch.sum((mean - target[traced:]) ** 2) / n)
    return loss, grads


def guard(grads: list) -> list:
    """NaNs to zero, then a global norm of at most MAX_GRAD_NORM."""
    grads = [torch.where(torch.isnan(g), 0.0, g) for g in grads]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < MAX_GRAD_NORM, g, g / norm * MAX_GRAD_NORM)
            for g in grads]


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(x) for k, x in params.items()}
        self.v = {k: torch.zeros_like(x) for k, x in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2 = BETAS
        self.t += 1
        out = {}
        for k, x in params.items():
            g = grads[k]
            self.m[k] = self.m[k] * b1 + g * (1 - b1)
            self.v[k] = self.v[k] * b2 + g * g * (1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + EPS
            out[k] = x - self.lr * m_hat / denom
        return out


def follow(sc, cfg, params: dict, pixel_ids, target, lr: float, steps: int,
           precision: str = "float32", fault: str | None = None) -> dict:
    """The first ``steps`` steps from ``params``: {"losses": [...],
    "first_grads": {leaf: the first step's gradient as Adam gets it (v0:
    as the loss gives it)}, "params": the params after the steps}."""
    p = {k: x.detach().clone() for k, x in params.items()}
    v0 = sc.v0.detach().clone()
    opt = Adam(p, lr)
    losses, first = [], None
    for k in range(steps):
        loss, g = loss_and_grads(sc, cfg, p, v0, pixel_ids, k, target,
                                 precision, fault=fault)
        names = list(p)
        guarded = dict(zip(names, guard([g[n] for n in names])))
        if first is None:
            first = dict(guarded, v0=g["v0"])
        p = opt.step(p, guarded)
        losses.append(loss)
    return {"losses": losses, "first_grads": first, "params": p}
