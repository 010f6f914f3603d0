"""Forward shading of one wavefront bounce in one kernel launch
(``csrc/wave_shade.cu``).

``integrator.trace_paths`` shades a bounce with this kernel when the call
can take it: the rays are on the card (``_kernels.takes_kernel``), it is
the forward route (no replay), no gradient is wanted and the bounce runs no
next-event estimation. Everything else, the CPU included, keeps the plain
body of ``trace_paths``' ``shade``, which is the kernel's twin: the kernel
computes that body's values in its order of operations and rounds them as
PyTorch's CUDA kernels do, so its outputs are the plain body's bit for bit
on the card (``tests/test_torch_wave_shade_cuda.py``).

``shade_tables`` packs what every bounce of a call reads (the material
table and the sky) once; ``shade_cuda`` launches one bounce, counted in
``KERNEL_LAUNCHES``. It writes either new planes or, with ``in_place``,
the state planes it was given, so a call's bounces after the first
allocate nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from offline_raytracer_tpu_torch.ops import _kernels

# launches of the shading kernel; chip runs read it to prove the bounces
# were shaded by the kernel
KERNEL_LAUNCHES = 0

# csrc/wave_shade.cu's flags
_RR_ON, _QUIRK_ON, _ROUGH_MAT = 1, 2, 4

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShadeTables:
    """The material table's rows and the sky, contiguous on the card."""

    kd: torch.Tensor        # (M, 3)
    ks: torch.Tensor        # (M, 3)
    kt: torch.Tensor        # (M, 3)
    ior: torch.Tensor       # (M,)
    spec_exp: torch.Tensor  # (M,)
    emit: torch.Tensor      # (M, 3)
    is_light: torch.Tensor  # (M,) bool
    sky: torch.Tensor | None  # (3, 3): bottom, top, up; None: no sky


def _inverse(x: float) -> float:
    """1.0f / float(x) in float32, as PyTorch divides by a Python float
    on the card (a product with the scalar's reciprocal)."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(x))


def _check(what, named, dev):
    for name, x, shape, dtype in named:
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, not {dev}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")


def shade_tables(materials, sky) -> ShadeTables:
    """The kernel's tables from a scene's ``Materials`` and ``Sky`` (or
    None), on a CUDA device; raises ValueError on another device, dtype or
    shape."""
    dev = materials.diffuse.device
    if dev.type != "cuda":
        raise ValueError(f"shade_tables needs CUDA tensors, got {dev}")
    M = materials.diffuse.shape[0]
    named = [("diffuse", materials.diffuse, (M, 3), _F32),
             ("specular", materials.specular, (M, 3), _F32),
             ("transmission", materials.transmission, (M, 3), _F32),
             ("ior", materials.ior, (M,), _F32),
             ("spec_exp", materials.spec_exp, (M,), _F32),
             ("emit", materials.emit, (M, 3), _F32),
             ("is_light", materials.is_light, (M,), torch.bool)]
    if sky is not None:
        named += [(f"sky.{k}", getattr(sky, k), (3,), _F32)
                  for k in ("bottom", "top", "up")]
    _check("shade_tables", named, dev)
    if M == 0:
        raise ValueError("shade_tables: the material table is empty")
    c = [x.detach().contiguous() for _, x, _, _ in named[:7]]
    return ShadeTables(
        *c, sky=None if sky is None else torch.stack(
            [sky.bottom, sky.top, sky.up]).detach().contiguous())


def shade_cuda(tables: ShadeTables, cfg, bounce: int, hit, state,
               u, in_place: bool = False):
    """One bounce of ``trace_paths``' shading without NEE in one kernel
    launch: ``hit`` the bounce's ``Hit``, ``state`` the planes (origin,
    direction, throughput, radiance, alive, prev_pdf) in, ``u`` its (8, R)
    uniform planes (``rng.uniform_planes(keys, bounce, 1, 8)``). Returns
    the six planes out: new tensors, or with ``in_place`` the planes of
    ``state`` (when contiguous) written over."""
    global KERNEL_LAUNCHES
    origin = state[0]
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"shade_cuda needs CUDA tensors, got {dev}")
    R = origin.shape[0]
    v3, v1 = (R, 3), (R,)
    named = [("hit.t", hit.t, v1, _F32), ("hit.normal", hit.normal, v3, _F32),
             ("hit.mat", hit.mat, v1, torch.int32),
             ("hit.valid", hit.valid, v1, torch.bool), ("u", u, (8, R), _F32)]
    named += [(name, x, shape, dtype) for name, x, shape, dtype in zip(
        ("origin", "direction", "throughput", "radiance", "alive",
         "prev_pdf"), state, (v3, v3, v3, v3, v1, v1),
        (_F32,) * 4 + (torch.bool, _F32))]
    _check("shade_cuda", named, dev)
    if 3 * R >= 2 ** 31:
        raise ValueError(f"shade_cuda: {R} lanes are past the kernel's "
                         f"32-bit indexing")
    ins = [x.detach().contiguous() for x in state]
    outs = ins if in_place else [torch.empty_like(x) for x in ins]
    if R == 0:
        return tuple(outs)
    rr = float(cfg.russian_roulette)
    flags = 0
    if rr < 1.0 and bounce >= cfg.rr_start_bounce:
        flags |= _RR_ON
    if cfg.reference_rr_quirk and rr < 1.0 and bounce > cfg.rr_start_bounce:
        flags |= _QUIRK_ON
    if cfg.roughness_from_material:
        flags |= _ROUGH_MAT
    t = tables
    hit_in = [x.detach().contiguous() for x in (hit.t, hit.normal, hit.mat,
                                                hit.valid, u)]
    _kernels.launch(
        "wave_shade", dev, *(x.data_ptr() for x in hit_in[:4]),
        *(x.data_ptr() for x in ins), hit_in[4].data_ptr(),
        t.kd.data_ptr(), t.ks.data_ptr(), t.kt.data_ptr(), t.ior.data_ptr(),
        t.spec_exp.data_ptr(), t.emit.data_ptr(), t.is_light.data_ptr(),
        None if t.sky is None else t.sky.data_ptr(),
        *(x.data_ptr() for x in outs), R, flags, float(cfg.hit_eps), rr,
        _inverse(rr), _inverse(np.pi), float(cfg.default_roughness))
    KERNEL_LAUNCHES += 1
    return tuple(outs)
