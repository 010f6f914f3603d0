"""Counter-based threefry-2x32 draws of the reference.

Frozen copy of ``offline_raytracer_tpu_torch/utils/rng.py`` at commit
7999567 (last changed in c7b6d06). The draws are the renderer's stated
semantics: a path's random numbers are a function of (seed, pixel, sample,
bounce, column), so the reference traces the same paths as the program
from the same seed, one ray at a time.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

# tag for camera draws, disjoint from bounce indices (tags 0..max_bounces)
CAMERA_TAG = 0x00C0FFEE


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Batched threefry-2x32 on int64 words: keys (k0, k1), counters (x0,
    x1) -> two output words (int64 in [0, 2**32))."""
    ks0, ks1 = k0, k1
    ks2 = ks0 ^ ks1 ^ 0x1BD11BDA

    def rounds(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    x0 = (x0 + ks0) & _MASK
    x1 = (x1 + ks1) & _MASK
    x0, x1 = rounds(x0, x1, _ROT_A)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 1) & _MASK
    x0, x1 = rounds(x0, x1, _ROT_B)
    x0, x1 = (x0 + ks2) & _MASK, (x1 + ks0 + 2) & _MASK
    x0, x1 = rounds(x0, x1, _ROT_A)
    x0, x1 = (x0 + ks0) & _MASK, (x1 + ks1 + 3) & _MASK
    x0, x1 = rounds(x0, x1, _ROT_B)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 4) & _MASK
    x0, x1 = rounds(x0, x1, _ROT_A)
    return (x0 + ks2) & _MASK, (x1 + ks0 + 5) & _MASK


def render_key(seed: int, device=None) -> torch.Tensor:
    """Root key (2,) for a render: the words [0, seed]."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(k0, k1, data):
    """jax.random.fold_in on word planes: -> the new key's two words."""
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def pixel_sample_keys(root, pixel_ids, sample_ids):
    """Per-ray keys (R, 2) for (pixel, spp-sample) pairs.

    A ray's whole random sequence is a function of (seed, pixel, sample),
    never of its slot in a batch.
    """
    pix = pixel_ids.to(torch.int64) & _MASK
    smp = sample_ids.to(torch.int64) & _MASK
    k0, k1 = fold_in(root[0].expand_as(pix), root[1].expand_as(pix), pix)
    k0, k1 = fold_in(k0, k1, smp)
    return torch.stack([k0, k1], dim=-1)


def _bits_to_unit(x):
    """32-bit word -> float32 in [0, 1) from its top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def tagged_uniform_planes(keys, tag: int, n: int):
    """(R, 2) keys + counter tag -> (n, R) uniform planes."""
    k0, k1 = keys[:, 0], keys[:, 1]
    x0 = torch.full_like(k0, int(tag) & _MASK)
    cols = []
    for j in range(0, n, 2):
        a, b = threefry2x32(k0, k1, x0, torch.full_like(k0, j))
        cols += [a, b]
    return torch.stack([_bits_to_unit(c) for c in cols[:n]], 0)


def tagged_uniforms(keys, tag: int, n: int):
    """(R, 2) keys + counter tag -> (R, n) uniforms."""
    return tagged_uniform_planes(keys, tag, n).T


def bounce_uniforms(keys, bounce: int, n: int):
    """All of one bounce's uniforms, (R, n): a value depends only on (seed,
    pixel, sample, bounce, column), never on the ray's batch slot."""
    return tagged_uniforms(keys, bounce, n)
