"""offline_raytracer_tpu_torch — the path tracer's PyTorch + CUDA port.

Mirrors the JAX package ``offline_raytracer_tpu`` module by module, so each
file here has a counterpart of the same name there. Host-side scene work
(builder, BVH, light tables, camera) is numpy; per-ray work is PyTorch.
Each of the JAX package's three TPU kernels has a hand-written CUDA C++
counterpart for Hopper with a plain-PyTorch version of the same contract
beside it: the fused bounce segment (``ops/mega.py``, ``csrc/mega.cu``),
and the cull-and-sweep and packet-walk triangle queries of the wavefront
route (``ops/traverse_cull.py``, ``ops/traverse_packet.py``,
``csrc/traverse_*.cu``). Tensors on a CUDA device go through the kernels,
tensors on the CPU through the plain versions, and any other device is
refused (``ops/_kernels.takes_kernel``); there is no fallback between the
two.

This package imports neither jax nor the JAX package: the tests hold it to
the JAX package by running the same inputs through both.
"""

__version__ = "0.1.0"

from offline_raytracer_tpu_torch.config import RenderConfig  # noqa: F401
