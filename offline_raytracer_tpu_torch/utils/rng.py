"""Counter-based RNG (counterpart of ``offline_raytracer_tpu/utils/rng.py``).

Reproduces the JAX package's threefry-2x32 draws bit for bit, so both
packages trace the same paths from the same (seed, pixel, sample, bounce):

- a key is a pair of 32-bit words; ``render_key(s)`` is ``[0, s]``;
- ``fold_in(k, d)`` is ``threefry2x32(k0, k1, 0, d)`` (jax.random.fold_in);
- uniform column j of a tag comes from counter ``(tag, j & ~1)``, word
  ``j & 1``, mapped to ``(word >> 8) * 2**-24``.

Keys are (R, 2) int64 tensors holding 32-bit words. The draws and the
per-ray keys follow the port's device rule (``ops/_kernels.takes_kernel``):

- CUDA tensors take the hand-written kernel ``csrc/threefry.cu`` (one
  launch per ``uniform_planes`` or ``pixel_sample_keys`` call, counted in
  ``KERNEL_LAUNCHES``), which draws in native uint32 arithmetic;
- CPU tensors take the plain version (``uniform_planes_plain``,
  ``pixel_sample_keys_plain``): the rounds on int64 words masked to 32
  bits, since PyTorch has no uint32 add or shift on the CPU. It is the
  reference the kernel is tested against, and the CPU tests hold it to
  ``jax.random``.

Both give the same bits, so the choice changes no output.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.ops import _kernels

_MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

# tag for camera draws, disjoint from bounce indices (tags 0..max_bounces)
CAMERA_TAG = 0x00C0FFEE

# launches of the CUDA kernel (both modes); chip runs read it to prove the
# draws went through the kernel
KERNEL_LAUNCHES = 0
# the kernel's modes (csrc/threefry.cu)
_MODE_PLANES, _MODE_KEYS = 0, 1


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


def _launch(mode, out, in0, in1=None, in2=None, tag_lo=0, n_tags=0, n=0):
    """One launch of ``csrc/threefry.cu`` writing ``out``, on the current
    stream, no sync."""
    global KERNEL_LAUNCHES
    _kernels.launch(
        "threefry", out.device, mode, in0.data_ptr(),
        None if in1 is None else in1.data_ptr(),
        None if in2 is None else in2.data_ptr(), out.data_ptr(),
        out.shape[-1] if mode == _MODE_PLANES else out.shape[0], tag_lo,
        n_tags, n)
    KERNEL_LAUNCHES += 1


def pixel_sample_keys_plain(root, pixel_ids, sample_ids):
    """``pixel_sample_keys`` in int64 PyTorch operations, on any device."""
    pix = pixel_ids.to(torch.int64) & _MASK
    smp = sample_ids.to(torch.int64) & _MASK
    k0, k1 = fold_in(root[0].expand_as(pix), root[1].expand_as(pix), pix)
    k0, k1 = fold_in(k0, k1, smp)
    return torch.stack([k0, k1], dim=-1)


def pixel_sample_keys_cuda(root, pixel_ids, sample_ids):
    """``pixel_sample_keys`` in one kernel launch, on CUDA tensors."""
    dev = pixel_ids.device
    if dev.type != "cuda" or root.device != dev or sample_ids.device != dev:
        raise ValueError(f"pixel_sample_keys_cuda needs the root, pixel ids "
                         f"and sample ids on one CUDA device, got "
                         f"{root.device}, {dev}, {sample_ids.device}")
    if root.shape != (2,) or root.dtype != torch.int64:
        raise ValueError(f"root must be a (2,) int64 key, got "
                         f"{tuple(root.shape)} {root.dtype}")
    pix, smp = torch.broadcast_tensors(pixel_ids, sample_ids)
    out = torch.empty(pix.shape + (2,), dtype=torch.int64, device=dev)
    if out.numel():
        # fold_in reads the low 32 bits of an id, all that int32 keeps
        pix, smp = (i.to(torch.int32).reshape(-1).contiguous()
                    for i in (pix, smp))
        _launch(_MODE_KEYS, out.view(-1, 2), root.contiguous(), pix, smp)
    return out


def pixel_sample_keys(root, pixel_ids, sample_ids):
    """Per-ray keys (R, 2) for (pixel, spp-sample) pairs: the kernel for
    CUDA pixel ids, the plain version for CPU ones.

    A ray's whole random sequence is a function of (seed, pixel, sample),
    never of its slot in a batch.
    """
    if _kernels.takes_kernel(pixel_ids.device, "threefry draw"):
        return pixel_sample_keys_cuda(root, pixel_ids, sample_ids)
    return pixel_sample_keys_plain(root, pixel_ids, sample_ids)


def _bits_to_unit(x):
    """32-bit word -> float32 in [0, 1) from its top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _tag_planes(keys, tag: int, n: int):
    """The plain (n, R) uniform planes of one tag."""
    k0, k1 = keys[:, 0], keys[:, 1]
    x0 = torch.full_like(k0, int(tag) & _MASK)
    cols = []
    for j in range(0, n, 2):
        a, b = threefry2x32(k0, k1, x0, torch.full_like(k0, j))
        cols += [a, b]
    return torch.stack([_bits_to_unit(c) for c in cols[:n]], 0)


def _check_draw(keys, n_tags: int, n: int):
    if (not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64
            or keys.dim() != 2 or keys.shape[1] != 2):
        raise ValueError(
            f"keys must be an (R, 2) int64 tensor, got "
            f"{getattr(keys, 'dtype', type(keys))} "
            f"{tuple(getattr(keys, 'shape', ()))}")
    if n_tags < 0 or n < 0:
        raise ValueError(f"n_tags and n must be >= 0, got {n_tags}, {n}")


def uniform_planes_plain(keys, tag_lo: int, n_tags: int, n: int):
    """``uniform_planes`` in int64 PyTorch operations, on any device."""
    _check_draw(keys, n_tags, n)
    if n_tags * n == 0:
        return torch.empty((0, keys.shape[0]), dtype=torch.float32,
                           device=keys.device)
    return torch.cat([_tag_planes(keys, tag_lo + i, n)
                      for i in range(n_tags)], 0)


def uniform_planes_cuda(keys, tag_lo: int, n_tags: int, n: int):
    """``uniform_planes`` in one kernel launch, on CUDA tensors."""
    _check_draw(keys, n_tags, n)
    if keys.device.type != "cuda":
        raise ValueError(f"uniform_planes_cuda needs CUDA tensors, got "
                         f"{keys.device}")
    out = torch.empty((n_tags * n, keys.shape[0]), dtype=torch.float32,
                      device=keys.device)
    if out.numel():
        _launch(_MODE_PLANES, out, keys.contiguous(),
                tag_lo=int(tag_lo) & _MASK, n_tags=n_tags, n=n)
    return out


def uniform_planes(keys, tag_lo: int, n_tags: int, n: int):
    """(R, 2) keys -> (n_tags * n, R) float32 uniform planes: rows
    [i * n, i * n + n) are the n uniforms of tag ``tag_lo + i`` (as
    ``tagged_uniform_planes``). The kernel for CUDA keys, the plain version
    for CPU keys."""
    if (isinstance(keys, torch.Tensor)
            and _kernels.takes_kernel(keys.device, "threefry draw")):
        return uniform_planes_cuda(keys, tag_lo, n_tags, n)
    return uniform_planes_plain(keys, tag_lo, n_tags, n)


def tagged_uniform_planes(keys, tag: int, n: int):
    """(R, 2) keys + counter tag -> (n, R) uniform planes."""
    return uniform_planes(keys, tag, 1, n)


def tagged_uniforms(keys, tag: int, n: int):
    """(R, 2) keys + counter tag -> (R, n) uniforms."""
    return tagged_uniform_planes(keys, tag, n).T


def bounce_uniforms(keys, bounce: int, n: int):
    """All of one bounce's uniforms, (R, n): a value depends only on (seed,
    pixel, sample, bounce, column), never on the ray's batch slot."""
    return tagged_uniforms(keys, bounce, n)
