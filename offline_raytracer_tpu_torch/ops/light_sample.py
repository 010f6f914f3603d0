"""The segment route's light-sample planes in one kernel launch
(``csrc/light_sample.cu``).

``ops/mega.render_paths_mega`` hands each segment of ``nf`` bounces the
next-event estimation's light samples as (10 * nf, Rp) planes: for bounce
i, rows 10i .. 10i + 9 hold the point, the normal, the emission and the
area pdf of the light sample drawn from the segment's uniform rows
8i .. 8i + 3 (pick, a, b, c). ``sample_planes`` makes them by the port's
device rule (``_kernels.takes_kernel``): on the card one launch of the
kernel, counted in ``KERNEL_LAUNCHES`` and, while the recorder is on, in
the counter ``mega.light_kernel`` (lanes x bounces); on the CPU
``sample_planes_plain``, one ``lights.sample_lights`` call a bounce, which
is the kernel's twin:
the kernel computes each sample in its order of operations and rounds as
PyTorch's CUDA kernels do, so its planes are the plain version's bit for
bit on the card (``tests/test_torch_light_sample_cuda.py``). Every lane is
sampled, dead ones too.
"""

from __future__ import annotations

import torch

from offline_raytracer_tpu_torch.ops import _kernels
from offline_raytracer_tpu_torch.ops.lights import AreaLights, sample_lights
from offline_raytracer_tpu_torch.utils import profiling

# launches of the light-sample kernel; chip runs read it to prove the
# segments' planes came from the kernel
KERNEL_LAUNCHES = 0

_F32, _I32 = torch.float32, torch.int32


def sample_planes_plain(u_all, nf: int, lights: AreaLights, emit):
    """(10 * nf, Rp) planes from (8 * nf, Rp) uniforms ``u_all``, one
    ``sample_lights`` call a bounce, on any device."""
    planes = []
    for i in range(nf):
        s = sample_lights(u_all[8 * i:8 * i + 4].T, lights, emit)
        planes += [s.p.T, s.normal.T, s.emit.T, s.pdf_area[None]]
    return torch.cat(planes, 0)


# the kernel's table arguments in its order: ``AreaLights``' fields, each
# (name, rows: lights "L" or emissive triangles "T", floats a row, dtype),
# then the material table's emission
TABLE = (("kind", "L", 1, _I32), ("mat", "L", 1, _I32),
         ("area", "L", 1, _F32), ("p0", "L", 3, _F32),
         ("axis", "L", 3, _F32), ("radius", "L", 1, _F32),
         ("rot", "L", 9, _F32), ("tri_lo", "L", 1, _I32),
         ("tri_hi", "L", 1, _I32), ("cdf_base", "L", 1, _F32),
         ("em_v0", "T", 3, _F32), ("em_v1", "T", 3, _F32),
         ("em_v2", "T", 3, _F32), ("em_cdf", "T", 1, _F32))


def _table(lights: AreaLights, emit, dev) -> list:
    """The kernel's table arguments in its order, each checked."""
    rows = {"L": lights.count, "T": lights.em_cdf.shape[0]}
    named = [(name, getattr(lights, name), rows[n], k, dtype)
             for name, n, k, dtype in TABLE]
    named.append(("emit", emit, emit.shape[0], 3, _F32))
    for name, x, n, k, dtype in named:
        if x.device != dev:
            raise ValueError(f"sample_planes_cuda: {name} is on {x.device}, "
                             f"not {dev}")
        if x.shape[:1] != (n,) or x.numel() != n * k or x.dtype != dtype:
            raise ValueError(f"sample_planes_cuda: {name} must hold {n} rows "
                             f"of {k} {dtype}, got {tuple(x.shape)} "
                             f"{x.dtype}")
    return [x.detach().contiguous() for _, x, _, _, _ in named]


def sample_planes_cuda(u_all, nf: int, lights: AreaLights, emit):
    """``sample_planes_plain`` in one kernel launch, on CUDA tensors. The
    emission table is read detached: the planes carry no graph. Launches
    on the current stream, no sync."""
    global KERNEL_LAUNCHES
    dev = u_all.device
    if dev.type != "cuda":
        raise ValueError(f"sample_planes_cuda needs CUDA tensors, got {dev}")
    Rp = u_all.shape[1]
    if u_all.dtype != _F32 or u_all.shape[0] != 8 * nf or nf < 1:
        raise ValueError(f"sample_planes_cuda: u_all must be (8 * nf, Rp) "
                         f"float32 with nf >= 1, got {tuple(u_all.shape)} "
                         f"{u_all.dtype} and nf {nf}")
    if lights.count < 1:
        raise ValueError("sample_planes_cuda: the light table is empty")
    if Rp >= 2 ** 31:
        raise ValueError(f"sample_planes_cuda: {Rp} lanes are past the "
                         f"kernel's 32-bit lane index")
    table = _table(lights, emit, dev)
    u = u_all.contiguous()
    out = torch.empty((10 * nf, Rp), dtype=_F32, device=dev)
    if Rp == 0:
        return out
    _kernels.launch("light_sample", dev, u.data_ptr(),
                    *(x.data_ptr() for x in table), out.data_ptr(), Rp, nf,
                    lights.count, lights.em_cdf.shape[0])
    KERNEL_LAUNCHES += 1
    # the lanes x bounces the kernel sampled, while the recorder is on
    profiling.count("mega.light_kernel", Rp * nf)
    return out


def sample_planes(u_all, nf: int, lights: AreaLights, emit):
    """A segment's (10 * nf, Rp) light-sample planes from its (8 * nf, Rp)
    uniforms: the kernel for CUDA tensors, the plain version for CPU
    tensors, an error for anything else."""
    if _kernels.takes_kernel(u_all.device, "light sample"):
        return sample_planes_cuda(u_all, nf, lights, emit)
    return sample_planes_plain(u_all, nf, lights, emit)
