"""Vector math (counterpart of ``offline_raytracer_tpu/utils/math.py``).

Batched over leading axes with the vector on the last axis, in the same
operation order as the JAX functions so float32 results agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def normalize(a, eps: float = EPS):
    """Safe normalize: a / max(|a|, eps).

    The length is ``torch.linalg.vector_norm``, a reduction kernel, and not
    ``torch.sqrt`` of the summed squares: on the CPU, ``torch.sqrt`` of
    more than 2048 values is cut into chunks for MKL's vector library
    across the intra-op threads, and one test run got roots good to ~11
    bits from the second thread's chunk (ROADMAP C)."""
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    return a / torch.clamp(n, min=eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def build_frame(n):
    """Orthonormal (t, b) completing unit normal n (..., 3), pole-safe."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    near_pole = torch.abs(nz) > 0.999
    inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny, min=EPS * EPS))
    zero = torch.zeros_like(nz)
    b_generic = torch.stack([-ny * inv, nx * inv, zero], dim=-1)
    b_pole = torch.stack([torch.ones_like(nz), zero, zero], dim=-1)
    b0 = torch.where(near_pole[..., None], b_pole, b_generic)
    t = normalize(cross(b0, n))
    b = cross(n, t)
    return t, b


def frame_to_world(local, n):
    """Map local (x, y, z) coordinates (z up = n) into world space."""
    t, b = build_frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def rotation_matrix_to_z(axis):
    """Rotation matrix (rows) mapping ``axis`` to +Z (numpy, host side)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    z = np.array([0.0, 0.0, 1.0])
    c = np.cross(z, a)
    if np.linalg.norm(c) < 1e-9:
        b = np.cross(np.array([1.0, 0.0, 0.0]), a)
        if np.linalg.norm(b) < 1e-9:
            b = np.cross(np.array([0.0, 1.0, 0.0]), a)
    else:
        b = c
    b = b / np.linalg.norm(b)
    cc = np.cross(a, b)
    return np.stack([b, cc, a]).astype(np.float32)
