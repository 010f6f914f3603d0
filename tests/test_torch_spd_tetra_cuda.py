"""Haines's SPD tetra at its benchmark size (size factor 8: 262,144
triangles in 2,048 leaves) on the card.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_spd_tetra_cuda.py``.

- Every triangle query of one full-size sample (8 bounces, a closest-hit
  and a shadow query each) goes through the cull kernel and equals the
  plain dense sweep on its live rays, as ``test_torch_traverse_cuda.py``
  holds them: slots and t bit for bit (the kernel's triangle test rounds
  as the plain one, its culls are conservative), hit bits of the shadow
  queries alike.
- A few launches of the benchmark cell ``spd_tetra.render`` (its loop,
  route check and comparison with ``portbench/reference/wave_bvh.py``)
  are ``correct`` within the cell's limits. The cell runs in a process of
  its own, ``portbench/run.py`` as the benchmark starts it: the harness
  fails a run whose process holds jax or the JAX package, which another
  test of the same session may have imported.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from offline_raytracer_tpu_torch import RenderConfig  # noqa: E402
from offline_raytracer_tpu_torch.ops import traverse, traverse_cull  # noqa
from offline_raytracer_tpu_torch.render import (  # noqa: E402
    render_block_stats, tile_pixel_ids)

CFG = RenderConfig(width=512, height=512, max_bounces=8, enable_dof=False,
                   roughness_from_material=True, ray_batch=1 << 18)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def queries(device):
    """Every triangle query of sample 0 over all 262,144 pixels, captured
    at the cull kernel's wrapper: [(ro, rd, t_far, any_hit, t, slot)]."""
    from offline_raytracer_tpu_torch.models import scenes

    scene = scenes.spd_tetra(device=device)
    assert scene.triangles.mat.shape[0] == 262144
    assert traverse.tri_tables(scene.tri_bvh).m_occ == 2048
    got = []
    original = traverse_cull.bvh_hit_ts_cull

    def spy(tables, ro, rd, t_min, t_far=None, any_hit=False):
        t, slot = original(tables, ro, rd, t_min, t_far, any_hit)
        got.append((tables, ro.clone(), rd.clone(), t_far.clone(), any_hit,
                    t.clone(), slot.clone()))
        return t, slot

    traverse_cull.bvh_hit_ts_cull = spy
    try:
        before = traverse_cull.KERNEL_LAUNCHES
        ids = torch.from_numpy(tile_pixel_ids(512, 512)).to(device)
        with torch.no_grad():
            render_block_stats(scene, CFG, ids, 0, 1)
        torch.cuda.synchronize()
        assert traverse_cull.KERNEL_LAUNCHES == before + 2 * CFG.max_bounces
    finally:
        traverse_cull.bvh_hit_ts_cull = original
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_sample_queries_match_plain(queries, any_hit):
    mine = [q for q in queries if q[4] == any_hit]
    assert len(mine) == CFG.max_bounces
    n_hits = 0
    for b, (tables, ro, rd, tf, _, t, slot) in enumerate(mine):
        live = traverse.live_rays(ro, tf, CFG.t_min)
        idx = live.nonzero(as_tuple=True)[0]
        assert (slot[~live] == -1).all(), f"bounce {b}: a dead ray hit"
        if idx.numel() == 0:
            continue
        t_p, s_p = traverse.tri_hit_plain(
            tables, ro[idx].contiguous(), rd[idx].contiguous(), CFG.t_min,
            tf[idx].contiguous(), any_hit)
        s_k, t_k = slot[idx].cpu().numpy(), t[idx].cpu().numpy()
        s_p, t_p = s_p.cpu().numpy(), t_p.cpu().numpy()
        n_hits += int((s_p >= 0).sum())
        if any_hit:
            np.testing.assert_array_equal(s_k >= 0, s_p >= 0,
                                          err_msg=f"bounce {b}")
            assert (t_k[s_k >= 0] == np.float32(CFG.t_min)).all()
        else:
            assert (s_k == s_p).all(), (
                f"bounce {b}: {(s_k != s_p).sum()} of {s_k.size} slots "
                f"differ")
            assert (t_k.view(np.int32) == t_p.view(np.int32)).all()
    assert n_hits > 1000


@pytest.mark.cuda
def test_cell_launches_are_correct(device):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "spd_tetra.render", "--seed", "3141592653",
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, r.stderr[-2000:]
    assert last["attempted"] >= 3
