"""offline_raytracer_tpu_torch — the path tracer's PyTorch + CUDA port.

Mirrors the JAX package ``offline_raytracer_tpu`` module by module, so each
file here has a counterpart of the same name there. Host-side scene work
(builder, BVH, light tables, camera) is numpy; per-ray work is PyTorch; the
fused bounce kernel (``ops/mega.py``) is hand-written CUDA C++ for Hopper
(``csrc/mega.cu``) with a plain-PyTorch version of the same contract beside
it. Tensors on a CUDA device go through the kernel, tensors on the CPU
through the plain version; there is no fallback between the two.

This package imports neither jax nor the JAX package: the tests hold it to
the JAX package by running the same inputs through both.
"""

__version__ = "0.1.0"

from offline_raytracer_tpu_torch.config import RenderConfig  # noqa: F401
