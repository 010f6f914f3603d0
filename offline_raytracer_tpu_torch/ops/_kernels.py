"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use
into a shared library with a plain C entry point, cached under
``build/kernels/`` at the repository root keyed on a hash of the source,
the headers beside it (``csrc/*.cuh``) and the flags, and loaded with
ctypes. ``LIBRARIES`` names each library's entry point, its argument types
and the flags it adds. No fast-math flags: the kernels rely on IEEE
division, on ``inf`` from ``1/0`` in slab tests and on exact ``sqrtf``.
The ray, sphere, shading and light-sample kernels are also built with
``-fmad=false``: no a*b+c is contracted to an FMA, so their triangle and
sphere tests, their shading and their light samples round exactly as the
plain PyTorch versions' do, and each
kernel's instantiations for each group size round alike (bitwise equal
outputs). ``build_all`` starts
one nvcc per source at once.

``takes_kernel`` is the port's one device rule and ``launch`` its one way
onto the card: every entry point takes the current stream as its last
argument and returns a CUDA error code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from offline_raytracer_tpu_torch.utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_EXACT = ["-fmad=false"]
# library -> (C entry point, its argument types, flags added to NVCC_FLAGS)
LIBRARIES = {
    "mega": ("mega_segment", [_P] * 10 + [_I] * 16 + [_F] * 3 + [_P],
             _EXACT),
    "traverse_cull": ("traverse_cull", [_P] * 8 + [_I] * 5 + [_F, _P],
                      _EXACT),
    "traverse_packet": ("traverse_packet", [_P] * 8 + [_I] * 5 + [_F, _P],
                        _EXACT),
    "threefry": ("threefry_draw", [_I] + [_P] * 4 + [_I, _U, _I, _I, _P],
                 []),
    "sphere_sweep": ("sphere_sweep", [_P] * 7 + [_I, _I, _F, _P], _EXACT),
    "wave_shade": ("wave_shade", [_P] * 25 + [_I] * 2 + [_F] * 5 + [_P],
                   _EXACT),
    "light_sample": ("light_sample", [_P] * 17 + [_I] * 4 + [_P], _EXACT),
}

_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is cached.

    Returns {"path", "seconds", "log", "cached"}; raises on a failed build.
    """
    src = os.path.join(SRC_DIR, f"{name}.cu")
    flags = NVCC_FLAGS + LIBRARIES[name][2]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0, "log": "", "cached": True}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.time()
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        profiling.count("kernels.built", 1)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": out, "seconds": time.time() - t0,
            "log": proc.stdout + proc.stderr, "cached": False}


def build_all(names) -> dict:
    """Build several libraries at once, one nvcc process each:
    {name: build(name)}; raises if any build fails."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str):
    """The ctypes entry point of kernel library ``name`` (built if needed)."""
    fn = _loaded.get(name)
    if fn is None:
        with profiling.span("kernels.load"):
            entry, argtypes, _ = LIBRARIES[name]
            lib = ctypes.CDLL(build(name)["path"])
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn


def launch(name: str, device, *args) -> None:
    """One launch of library ``name``'s entry point with ``args`` on
    ``device``'s current stream, whose handle it appends; no sync. Raises
    RuntimeError on a non-zero return."""
    fn = load(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def takes_kernel(device: torch.device, what: str) -> bool:
    """The port's device rule: True for a CUDA device (take the kernel),
    False for the CPU (take the plain version); any other device raises
    ValueError naming ``what`` and the device."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no {what} for device {device}")
