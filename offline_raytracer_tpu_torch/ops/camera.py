"""Camera rays with thin-lens DOF (counterpart of ``ops/camera.py``).

``make_camera`` is numpy host code; ``generate_rays`` runs in torch on the
device of ``pixel_ids`` and draws its jitter and aperture uniforms from the
same threefry counters as the JAX package (``rng.CAMERA_TAG``).
"""

from __future__ import annotations

import numpy as np
import torch

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.scene.types import Camera
from offline_raytracer_tpu_torch.utils import rng
from offline_raytracer_tpu_torch.utils.math import normalize

PI = float(np.pi)


def make_camera(p, height_ratio, quaternion_xyzw, width, height) -> Camera:
    """Camera from .scn parameters (position, height ratio, xyzw quat)."""
    p = np.asarray(p, np.float32)
    q = np.asarray(quaternion_xyzw, np.float64)
    qv, w = q[:3], q[3]

    def rot(v):
        t = 2.0 * np.cross(qv, v)
        return (v + w * t + np.cross(qv, t)).astype(np.float32)

    aspect = width / height
    t = torch.from_numpy
    return Camera(
        p=t(p.copy()),
        x_axis=t(np.asarray(height_ratio * aspect * rot([1.0, 0.0, 0.0]),
                            np.float32)),
        y_axis=t(np.asarray(height_ratio * rot([0.0, 1.0, 0.0]), np.float32)),
        z_axis=t(rot([0.0, 0.0, 1.0])),
    )


def generate_rays(cam: Camera, cfg: RenderConfig, pixel_ids, keys):
    """Primary rays for flat pixel ids (R,) -> (origin (R,3), dir (R,3)).

    pixel_id = y * width + x with y = 0 the bottom row. ``keys`` are the
    per-ray (R, 2) keys of ``rng.pixel_sample_keys``.
    """
    x = (pixel_ids % cfg.width).to(torch.float32)
    y = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(
        torch.float32)

    u = rng.tagged_uniforms(keys, rng.CAMERA_TAG, 4)
    if cfg.pixel_jitter:
        x = x + u[..., 0]
        y = y + u[..., 1]

    px = 2.0 * x / cfg.width - 1.0
    py = 2.0 * y / cfg.height - 1.0

    cam_to_pixel = normalize(
        px[..., None] * cam.x_axis + py[..., None] * cam.y_axis - cam.z_axis)

    if not cfg.enable_dof:
        return cam.p.expand_as(cam_to_pixel), cam_to_pixel

    anchor = torch.tensor([0.0, 0.0, cfg.focal_anchor_z],
                          dtype=torch.float32, device=cam.p.device)
    rel = cam.p - anchor
    focal_len = torch.sqrt(torch.sum(rel * rel))
    focal_point = cam.p + focal_len * cam_to_pixel

    theta = 2.0 * PI * u[..., 2]
    if cfg.aperture_disk:
        r = cfg.aperture_radius * torch.sqrt(u[..., 3])
    else:
        # the reference samples the aperture rim only (ring bokeh)
        r = torch.full_like(theta, cfg.aperture_radius)
    origin = (cam.p
              + (r * torch.cos(theta))[..., None] * cam.x_axis
              + (r * torch.sin(theta))[..., None] * cam.y_axis
              - 0.1 * cam.z_axis)
    direction = normalize(focal_point - origin)
    return origin, direction
