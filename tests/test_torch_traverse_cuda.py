"""The two traversal kernels vs the plain dense sweep on the card.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_traverse_cuda.py``.

Bounds: the kernels' triangle test rounds exactly as the plain version's
(built with -fmad=false, same expression order), and both kernels' culls
(leaf boxes, tree nodes, sub-boxes) are conservative, so no differing ray
is allowed: closest-hit slots and t equal the dense sweep's bit for bit,
and so do the occlusion bits. The cull kernel visits leaves in slot order,
so its any-hit slot is the dense sweep's least hit slot too; the tree walk
returns the least hit slot of the first leaf it reaches that holds one.
"""

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch.ops import (
    traverse, traverse_cull, traverse_packet)
from offline_raytracer_tpu_torch.ops.bvh import build_tri_bvh
from torch_port_cases import random_rays, random_tris

T_MIN = 1e-6
KERNELS = {"cull": traverse_cull, "packet": traverse_packet}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _tables(n, device, seed=5):
    v0, v1, v2 = random_tris(n, seed=seed, spread=4.0 * (n / 3000) ** (1 / 3))
    tables = traverse.tri_tables(
        build_tri_bvh(v0, v1, v2, np.zeros(n, np.int32)).to(device))
    return tables, (v0 + v1 + v2) / 3


def _random_case(device, n=3000, R=1000):
    """3,000 random triangles (24 leaves) and 1,000 rays (not a multiple
    of 128), every other one aimed at a triangle."""
    tables, c = _tables(n, device)
    ro, rd = random_rays(R, seed=7, targets=c)
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


def _case(name, device):
    return (_random_case if name == "random" else _stand_in_case)(device)


def _t_far(R, device):
    tf = np.random.RandomState(3).uniform(0.5, 12.0, R).astype(np.float32)
    tf[::6] = 0.0                                   # dead lanes
    return torch.from_numpy(tf).to(device)


def _query(kernel, tables, ro, rd, t_far=None, any_hit=False, group=None):
    mod = KERNELS[kernel]
    out = getattr(mod, f"bvh_hit_ts_{kernel}_cuda")(
        tables, ro, rd, T_MIN, t_far, any_hit, group=group)
    return tuple(x.cpu().numpy() for x in out)


def _check_closest(got, ref):
    (t, s), (t_p, s_p) = got, ref
    assert (s == s_p).all(), f"{(s != s_p).sum()} of {s.size} slots differ"
    assert (t.view(np.int32) == t_p.view(np.int32)).all()
    assert np.isinf(t[s < 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", ["random", "stand-in"])
def test_closest_hit_matches_plain(device, kernel, case):
    tables, ro, rd = _case(case, device)
    mod = KERNELS[kernel]
    before = mod.KERNEL_LAUNCHES
    t, s = getattr(mod, f"bvh_hit_ts_{kernel}")(tables, ro, rd, T_MIN)
    assert mod.KERNEL_LAUNCHES == before + 1
    ref = tuple(x.cpu().numpy()
                for x in traverse.tri_hit_plain(tables, ro, rd, T_MIN))
    assert (ref[1] >= 0).sum() > 0.2 * ref[1].size
    _check_closest((t.cpu().numpy(), s.cpu().numpy()), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", ["random", "stand-in"])
def test_any_hit_matches_plain(device, kernel, case):
    tables, ro, rd = _case(case, device)
    tf = _t_far(ro.shape[0], device)
    t, s = _query(kernel, tables, ro, rd, tf, any_hit=True)
    _, s_p = (x.cpu().numpy() for x in traverse.tri_hit_plain(
        tables, ro, rd, T_MIN, tf, any_hit=True))
    assert (s_p >= 0).any()
    np.testing.assert_array_equal(s >= 0, s_p >= 0)
    assert not (s[::6] >= 0).any()
    assert (t[s >= 0] == np.float32(T_MIN)).all() and np.isinf(t[s < 0]).all()
    if kernel == "cull":
        np.testing.assert_array_equal(s, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_groups_bitwise_equal(device, kernel, any_hit):
    """Every lanes-per-ray G gives bitwise the G = 1 outputs."""
    tables, ro, rd = _stand_in_case(device, R=2048)
    tf = _t_far(ro.shape[0], device) if any_hit else None
    ref = _query(kernel, tables, ro, rd, tf, any_hit, group=1)
    assert (ref[1] >= 0).any()
    for g in traverse.GROUPS[1:]:
        got = _query(kernel, tables, ro, rd, tf, any_hit, group=g)
        for r, k in zip(ref, got):
            assert (r.view(np.int32) == k.view(np.int32)).all(), f"G={g}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_late_bounce_few_live_among_parked(device, kernel):
    """A late bounce: 300 live rays scattered among 262,144, the rest
    parked at 1e8 and dead (t_far = 0, as the integrator launches them in
    both queries): misses for the dead, the dense sweep's answers for the
    live."""
    tables, ro, rd = _stand_in_case(device, R=4096)
    R = 1 << 18
    rs = np.random.RandomState(11)
    pick = rs.choice(R, 300, replace=False)
    ro_l = torch.full((R, 3), 1e8, device=device)
    rd_l = torch.from_numpy(rs.randn(R, 3).astype(np.float32)).to(device)
    rd_l = rd_l / rd_l.norm(dim=1, keepdim=True)
    src = torch.from_numpy(rs.randint(0, ro.shape[0], 300)).to(device)
    pick_t = torch.from_numpy(pick).to(device)
    ro_l[pick_t], rd_l[pick_t] = ro[src], rd[src]
    tf = torch.zeros((R,), device=device)
    tf[pick_t] = float("inf")
    assert int(traverse.live_rays(ro_l, tf, T_MIN).sum()) == 300
    got = _query(kernel, tables, ro_l, rd_l, tf)
    ref = tuple(x.cpu().numpy()
                for x in traverse.tri_hit_plain(tables, ro_l, rd_l, T_MIN, tf))
    _check_closest(got, ref)
    dead = np.ones(R, bool)
    dead[pick] = False
    assert (got[1][dead] == -1).all() and (got[1][pick] >= 0).any()
    tf[pick_t] = 1e3
    _, s = _query(kernel, tables, ro_l, rd_l, tf, any_hit=True)
    _, s_p = traverse.tri_hit_plain(tables, ro_l, rd_l, T_MIN, tf,
                                    any_hit=True)
    np.testing.assert_array_equal(s >= 0, s_p.cpu().numpy() >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_far_origin_rays_keep_their_hits(device, kernel):
    """Rays from 2e7 above a triangle 2e6 across (the scene and rays of
    tests/test_torch_far_origin.py): both kernels hit what the dense sweep
    hits, slots and t bit for bit, every downward ray a hit; with t_far = 0
    on every 5th ray those miss and the rest are unchanged."""
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder
    from torch_port_cases import far_origin_recipe, far_origin_rays

    scene = far_origin_recipe(SceneBuilder).build(64, 64, device=device)
    tables = traverse.tri_tables(scene.tri_bvh)
    ro, rd = (torch.from_numpy(x).to(device) for x in far_origin_rays())
    ref = tuple(x.cpu().numpy()
                for x in traverse.tri_hit_plain(tables, ro, rd, T_MIN))
    down = np.ones(ro.shape[0], bool)
    down[::4] = False
    assert (ref[1][down] >= 0).all() and (ref[1][~down] == -1).all()
    _check_closest(_query(kernel, tables, ro, rd), ref)
    tf = torch.full((ro.shape[0],), float("inf"), device=device)
    tf[::5] = 0.0
    t, s = _query(kernel, tables, ro, rd, tf)
    assert (s[::5] == -1).all()
    live = np.ones(ro.shape[0], bool)
    live[::5] = False
    np.testing.assert_array_equal(s[live], ref[1][live])
    assert (t[live].view(np.int32) == ref[0][live].view(np.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_tree_at_the_cull_limit(device, kernel):
    """A tree of 4,096 leaves (524,288 triangles), cull_ok's limit: the
    cull kernel's bitmap is full, and both kernels agree with the dense
    sweep."""
    n = traverse_cull.MAX_CULL_LEAVES * 128
    tables, c = _tables(n, device, seed=2)
    assert tables.m_occ == traverse_cull.MAX_CULL_LEAVES
    assert traverse_cull.cull_ok(tables)
    ro, rd = (torch.from_numpy(x).to(device)
              for x in random_rays(1024, seed=4, spread=20.0, targets=c))
    ref = tuple(x.cpu().numpy()
                for x in traverse.tri_hit_plain(tables, ro, rd, T_MIN))
    assert (ref[1] >= 0).sum() > 0.2 * ro.shape[0]
    _check_closest(_query(kernel, tables, ro, rd), ref)


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(device):
    import dataclasses

    tables, ro, rd = _random_case(device, R=256)
    for fn in (traverse_cull.bvh_hit_ts_cull_cuda,
               traverse_packet.bvh_hit_ts_packet_cuda):
        with pytest.raises(TypeError):
            fn(tables, ro.double(), rd, T_MIN)
        with pytest.raises(ValueError):
            fn(tables, ro[:, :2].contiguous(), rd, T_MIN)
        with pytest.raises(ValueError, match="group"):
            fn(tables, ro, rd, T_MIN, group=3)
        with pytest.raises(ValueError, match="sub-boxes"):
            fn(dataclasses.replace(tables, sub=None), ro, rd, T_MIN)
