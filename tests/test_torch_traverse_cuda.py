"""The two traversal kernels vs the plain dense sweep on the card.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_traverse_cuda.py``.

Bounds: the kernels' triangle test rounds exactly as the plain version's
(built with -fmad=false, same expression order), so slots and t agree
except where the cull's exact (not conservative) leaf-box test drops a
leaf whose triangle the dense sweep hits at a box face; 0.2% of live rays
may differ, as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch.ops import (
    traverse, traverse_cull, traverse_packet)
from offline_raytracer_tpu_torch.ops.bvh import build_tri_bvh
from torch_port_cases import random_rays, random_tris

BUDGET = 0.002
T_MIN = 1e-6
KERNELS = {"cull": traverse_cull, "packet": traverse_packet}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _random_case(device, n=3000, R=1000):
    """3,000 random triangles (24 leaves) and 1,000 rays (not a multiple
    of 128), every other one aimed at a triangle."""
    v0, v1, v2 = random_tris(n, seed=5)
    tables = traverse.tri_tables(
        build_tri_bvh(v0, v1, v2, np.zeros(n, np.int32)).to(device))
    ro, rd = random_rays(R, seed=7, targets=(v0 + v1 + v2) / 3)
    return (tables, torch.from_numpy(ro).to(device),
            torch.from_numpy(rd).to(device))


def _stand_in_case(device, R=4096):
    """Camera rays of the bunny stand-in (69,451 triangles), every 64th
    pixel of the 512x512 tile order."""
    import chip_smoke
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.render import tile_pixel_ids
    from offline_raytracer_tpu_torch.utils import rng

    scene = chip_smoke.bunny_stand_in(device)
    cfg = RenderConfig(width=512, height=512, enable_dof=False)
    ids = torch.from_numpy(tile_pixel_ids(512, 512)[::64][:R]).to(device)
    keys = rng.pixel_sample_keys(rng.render_key(0, device), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    return traverse.tri_tables(scene.tri_bvh), ro.contiguous(), rd.contiguous()


def _t_far(R, device):
    tf = np.random.RandomState(3).uniform(0.5, 12.0, R).astype(np.float32)
    tf[::6] = 0.0                                   # dead lanes
    return torch.from_numpy(tf).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", ["random", "stand-in"])
def test_closest_hit_matches_plain(device, kernel, case):
    tables, ro, rd = (_random_case if case == "random" else _stand_in_case)(
        device)
    mod = KERNELS[kernel]
    before = mod.KERNEL_LAUNCHES
    t, s = getattr(mod, f"bvh_hit_ts_{kernel}")(tables, ro, rd, T_MIN)
    assert mod.KERNEL_LAUNCHES == before + 1
    t_p, s_p = traverse.tri_hit_plain(tables, ro, rd, T_MIN)
    t, s, t_p, s_p = (x.cpu().numpy() for x in (t, s, t_p, s_p))
    assert (s_p >= 0).sum() > 0.2 * s.size
    same = s == s_p
    assert (~same).mean() <= BUDGET, f"{(~same).sum()} slots differ"
    hit = same & (s >= 0)
    np.testing.assert_allclose(t[hit], t_p[hit], rtol=1e-5)
    assert np.isinf(t[s < 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", ["random", "stand-in"])
def test_any_hit_matches_plain(device, kernel, case):
    tables, ro, rd = (_random_case if case == "random" else _stand_in_case)(
        device)
    tf = _t_far(ro.shape[0], device)
    mod = KERNELS[kernel]
    _, s = getattr(mod, f"bvh_hit_ts_{kernel}")(tables, ro, rd, T_MIN, tf,
                                                any_hit=True)
    _, s_p = traverse.tri_hit_plain(tables, ro, rd, T_MIN, tf, any_hit=True)
    occ, occ_p = s.cpu().numpy() >= 0, s_p.cpu().numpy() >= 0
    assert occ_p.any()
    assert (occ != occ_p).mean() <= BUDGET
    assert not occ[::6].any()


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(device):
    tables, ro, rd = _random_case(device, R=256)
    for fn in (traverse_cull.bvh_hit_ts_cull_cuda,
               traverse_packet.bvh_hit_ts_packet_cuda):
        with pytest.raises(TypeError):
            fn(tables, ro.double(), rd, T_MIN)
        with pytest.raises(ValueError):
            fn(tables, ro[:, :2].contiguous(), rd, T_MIN)
