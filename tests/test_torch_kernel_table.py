"""The port's kernel libraries and device rule, checked on the CPU.

``ops/_kernels.LIBRARIES`` gives each ``csrc/*.cu`` library its C entry
point and the ctypes argument types it is called with. A type that does
not match the C parameter corrupts the call only on the card, so the table
is held here to the parameters parsed from each source. The dispatchers of
the seven kernels follow one device rule (``_kernels.takes_kernel``): CUDA
takes the kernel, the CPU the plain version, any other device is refused.
"""

import ctypes
import glob
import os
import re

import pytest
import torch

from offline_raytracer_tpu_torch.ops import (
    _kernels, intersect, light_sample, mega, traverse_cull, traverse_packet,
    wave_shade)
from offline_raytracer_tpu_torch.utils import rng

_C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
            "float": ctypes.c_float}


def _c_params(src: str, entry: str) -> list:
    """The ctypes kind of each parameter of ``extern "C" int entry(...)``:
    a pointer, int, unsigned int or float."""
    found = re.findall(r'extern\s+"C"\s+int\s+' + entry + r'\s*\(([^)]*)\)',
                       src)
    assert len(found) == 1, f"{entry}: {len(found)} C entry points"
    kinds = []
    for param in found[0].split(","):
        words = param.split()
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append(_C_TYPES[" ".join(words[:-1])])
    return kinds


def test_library_table_matches_the_sources():
    names = {os.path.basename(p)[:-3]
             for p in glob.glob(os.path.join(_kernels.SRC_DIR, "*.cu"))}
    assert names == set(_kernels.LIBRARIES)
    for name, (entry, argtypes, flags) in _kernels.LIBRARIES.items():
        with open(os.path.join(_kernels.SRC_DIR, f"{name}.cu")) as f:
            params = _c_params(f.read(), entry)
        assert argtypes == params, name
        assert argtypes[-1] is ctypes.c_void_p, f"{name}: no stream last"
        assert not any("fast-math" in f or "use_fast_math" in f
                       for f in _kernels.NVCC_FLAGS + flags), name


def test_light_sample_row_takes_the_table_in_order():
    """``csrc/light_sample.cu``'s row: the uniforms, the wrapper's table
    arguments by name in ``light_sample.TABLE``'s order and the emission,
    the planes out, four ints, the stream."""
    entry, argtypes, flags = _kernels.LIBRARIES["light_sample"]
    with open(os.path.join(_kernels.SRC_DIR, "light_sample.cu")) as f:
        src = f.read()
    assert argtypes == _c_params(src, entry)
    assert "-fmad=false" in flags
    params = re.findall(r'extern\s+"C"\s+int\s+light_sample\s*\(([^)]*)\)',
                        src)[0].split(",")
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == (["u"] + [name for name, *_ in light_sample.TABLE]
                     + ["emit", "out", "Rp", "nf", "L", "T", "stream"])


def test_dispatchers_refuse_another_device():
    meta = torch.zeros((128, 3), device="meta")
    ids = torch.zeros((128,), dtype=torch.int32, device="meta")
    keys = torch.zeros((128, 2), dtype=torch.int64, device="meta")
    calls = {
        "segment": lambda: mega.mega_segment(
            torch.zeros((11, 128), device="meta"), None, None, None, None),
        "cull": lambda: traverse_cull.bvh_hit_ts_cull(None, meta, meta, 0.0),
        "packet": lambda: traverse_packet.bvh_hit_ts_packet(
            None, meta, meta, 0.0),
        "sphere sweep": lambda: intersect.sphere_sweep(None, meta, meta,
                                                       0.0),
        "keys": lambda: rng.pixel_sample_keys(keys[0], ids, ids),
        "planes": lambda: rng.uniform_planes(keys, 0, 1, 8),
        "wavefront shading": lambda: wave_shade.shade_cuda(
            None, None, 0, None, (meta,), None),
        "light sample": lambda: light_sample.sample_planes(
            torch.zeros((8, 128), device="meta"), 1, None, None),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="meta"):
            call()
