"""The sphere sweep kernel (``csrc/sphere_sweep.cu``) vs the plain sweep on
the card: the same winners as ``sphere_ts(...).min(-1)`` and the same
distances bit for bit, over the final scene of *Ray Tracing in One
Weekend* (486 spheres), over a table of 5,000 spheres (several
shared-memory tiles) and at ray counts around the kernel's chunk; a dead
lane a miss; strided rays; the wrapper's refusals; and a wavefront render
of the final scene bitwise equal with the plain sweep forced.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_sphere_sweep_cuda.py``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import intersect
from offline_raytracer_tpu_torch.render import render_block_stats
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.scene.types import Spheres

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHUNK = 2048          # lanes a block of the kernel compacts
T_MIN = 0.001         # the final scene's t_min


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _rtiow(dev, width=1200, height=675):
    from portbench.inputs import recipe

    with open(os.path.join(ROOT, "portbench", "configs",
                           "rtiow_final.json")) as f:
        c = json.load(f)
    b = recipe.apply(SceneBuilder(), recipe.calls(c["scene"]), c["camera"])
    b.set_sky(**c["sky"])
    r = dict(c["render"], width=width, height=height)
    return b.build(width, height, device=dev), RenderConfig(**r)


def _random_spheres(n, seed, dev):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    r = rs.uniform(0.05, 1.0, n).astype(np.float32)
    return Spheres(center=torch.from_numpy(c).to(dev),
                   radius=torch.from_numpy(r).to(dev),
                   mat=torch.zeros(n, dtype=torch.int32, device=dev))


def _rays(sph, n, seed, dev):
    """n rays of four kinds, a quarter each: from random points of the
    spheres' box, from just inside a sphere, from a sphere's surface
    outwards and inwards, and grazing a sphere; unit directions."""
    rs = np.random.RandomState(seed)
    c = sph.center.cpu().numpy()
    r = sph.radius.cpu().numpy()
    lo, hi = c.min(0) - 1.0, c.max(0) + 1.0
    lo[2], hi[2] = max(lo[2], -2.0), min(max(hi[2], 3.0), 12.0)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = rs.randint(0, len(r), n)
    o = rs.uniform(lo, hi, (n, 3))
    q = n // 4
    o[q:2 * q] = c[k[q:2 * q]] + d[q:2 * q] * (0.5 * r[k[q:2 * q]])[:, None]
    o[2 * q:3 * q] = (c[k[2 * q:3 * q]]
                      + d[2 * q:3 * q] * r[k[2 * q:3 * q]][:, None])
    d[2 * q:3 * q] *= np.where(rs.rand(q) < 0.5, 1.0, -1.0)[:, None]
    # grazing: aim at a point at distance ~r from the centre, off-axis
    g = slice(3 * q, n)
    side = np.cross(d[g], rs.normal(size=(n - 3 * q, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    aim = (c[k[g]] + side * (r[k[g]] * (1.0 + rs.uniform(-1e-4, 1e-4,
                                                         n - 3 * q)))[:, None])
    o[g] = aim - d[g] * rs.uniform(1.0, 5.0, n - 3 * q)[:, None]
    as_t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    return as_t(o).contiguous(), as_t(d).contiguous()


def _plain(sph, ro, rd, t_min, chunk=1 << 16):
    """sphere_ts(...).min(-1) on the card, in chunks of rays."""
    ts, ids = [], []
    for i in range(0, ro.shape[0], chunk):
        t, idx = intersect.sphere_ts(sph, ro[i:i + chunk], rd[i:i + chunk],
                                     t_min).min(-1)
        ts.append(t)
        ids.append(idx.to(torch.int32))
    return torch.cat(ts), torch.cat(ids)


def _kernel(sph, ro, rd, t_min, alive=None):
    before = intersect.KERNEL_LAUNCHES
    t, idx = intersect.sphere_sweep_cuda(sph, ro, rd, t_min, alive)
    torch.cuda.synchronize()      # a fault in the run shows here
    assert intersect.KERNEL_LAUNCHES == before + 1
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    return t, idx


def _assert_same(got, want, lanes=None):
    (kt, ki), (pt, pi) = got, want
    if lanes is not None:
        kt, ki, pt, pi = kt[lanes], ki[lanes], pt[lanes], pi[lanes]
    assert torch.equal(ki, pi), f"{int((ki != pi).sum())} winners differ"
    differ = int((kt.view(torch.int32) != pt.view(torch.int32)).sum())
    assert differ == 0, f"{differ} of {kt.shape[0]} distances differ"


@pytest.mark.cuda
def test_rtiow_winners(device):
    """2**20 rays over the final scene's 486 spheres: the plain sweep's
    winners and distances, bit for bit, on every lane."""
    scene, _ = _rtiow(device, 64, 36)
    sph = scene.spheres
    ro, rd = _rays(sph, 1 << 20, 0, device)
    want = _plain(sph, ro, rd, T_MIN)
    assert int(torch.isfinite(want[0]).sum()) > (1 << 18)
    _assert_same(_kernel(sph, ro, rd, T_MIN), want)


@pytest.mark.cuda
def test_dead_lanes_are_misses(device):
    """A dead lane is t = +inf, index 0; the live lanes the plain sweep's
    answers."""
    scene, _ = _rtiow(device, 64, 36)
    sph = scene.spheres
    R = 300001
    ro, rd = _rays(sph, R, 1, device)
    g = torch.Generator().manual_seed(1)
    alive = (torch.rand(R, generator=g) < 0.05).to(device)
    t, idx = _kernel(sph, ro, rd, T_MIN, alive)
    assert torch.isinf(t[~alive]).all() and (t[~alive] > 0).all()
    assert (idx[~alive] == 0).all()
    _assert_same((t, idx), _plain(sph, ro, rd, T_MIN), alive)
    none = torch.zeros(R, dtype=torch.bool, device=device)
    t, idx = _kernel(sph, ro, rd, T_MIN, none)
    assert torch.isinf(t).all() and (idx == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_table_past_one_tile(device, masked):
    """5,000 spheres, several shared-memory tiles: the same winners."""
    sph = _random_spheres(5000, 2, device)
    R = 100003
    ro, rd = _rays(sph, R, 2, device)
    alive = None
    if masked:
        g = torch.Generator().manual_seed(2)
        alive = (torch.rand(R, generator=g) < 0.5).to(device)
    want = _plain(sph, ro, rd, T_MIN, chunk=1 << 14)
    assert int((want[1] >= 1024).sum()) > 1000     # winners past tile 0
    _assert_same(_kernel(sph, ro, rd, T_MIN, alive), want, alive)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 31, CHUNK - 1, CHUNK, CHUNK + 1,
                               7 * CHUNK + 5])
@pytest.mark.parametrize("N", [1, 486])
def test_ray_counts_around_the_chunk(device, R, N):
    scene, _ = _rtiow(device, 64, 36)
    sph = scene.spheres
    if N == 1:
        sph = dataclasses.replace(sph, center=sph.center[3:4].contiguous(),
                                  radius=sph.radius[3:4].contiguous(),
                                  mat=sph.mat[3:4].contiguous())
    ro, rd = _rays(scene.spheres, R, R, device)
    want = _plain(sph, ro, rd, T_MIN)
    _assert_same(_kernel(sph, ro, rd, T_MIN), want)
    alive = torch.arange(R, device=device) % 3 == 1
    _assert_same(_kernel(sph, ro, rd, T_MIN, alive), want, alive)


@pytest.mark.cuda
def test_wrapper_refuses(device):
    scene, _ = _rtiow(device, 64, 36)
    sph = scene.spheres
    ro, rd = _rays(sph, 64, 3, device)
    alive = torch.ones(64, dtype=torch.bool, device=device)
    bad = [
        (ro.double(), rd, sph, alive),
        (ro, rd[:32], sph, alive),
        (ro, rd, sph, alive.to(torch.uint8)),
        (ro, rd, sph, alive[:32]),
        (ro.cpu(), rd, sph, alive),
        (ro, rd, dataclasses.replace(sph, center=sph.center[:0],
                                     radius=sph.radius[:0]), alive),
    ]
    for a, b, s, m in bad:
        with pytest.raises(ValueError):
            intersect.sphere_sweep_cuda(s, a, b, T_MIN, m)
    t, idx = intersect.sphere_sweep_cuda(sph, ro[:0], rd[:0], T_MIN)
    assert t.shape == idx.shape == (0,)


@pytest.mark.cuda
def test_strided_rays(device):
    """An origin expanded over the rays (the camera's without depth of
    field) and a transposed direction plane give the contiguous inputs'
    answers."""
    scene, _ = _rtiow(device, 64, 36)
    sph = scene.spheres
    ro, rd = _rays(sph, 4099, 4, device)
    one = ro[:1].expand(4099, 3)
    strided = rd.t().contiguous().t()
    assert one.stride(0) == 0 and not strided.is_contiguous()
    _assert_same(_kernel(sph, one, strided, T_MIN),
                 _plain(sph, one.contiguous(), rd, T_MIN))


@pytest.mark.cuda
def test_render_bitwise_with_plain_forced(device, monkeypatch):
    """The final scene at 64x36 through the wavefront route: the kernel's
    render (the closest-hit queries answering dead lanes as misses) equals
    the render with the plain sweep over every lane, bit for bit; one
    launch a bounce, no plain sweep."""
    scene, cfg = _rtiow(device, 64, 36)
    cfg = cfg.replace(max_bounces=12)
    ids = torch.arange(64 * 36, dtype=torch.int32, device=device)

    def refuse(*args):
        raise AssertionError("a plain sphere sweep ran on the card")

    with monkeypatch.context() as m:
        m.setattr(intersect, "sphere_ts", refuse)
        before = intersect.KERNEL_LAUNCHES
        got = render_block_stats(scene, cfg, ids, 3, 1)
    assert intersect.KERNEL_LAUNCHES == before + cfg.max_bounces

    def plain(sph, ro, rd, t_min, alive=None):
        t, idx = intersect.sphere_ts(sph, ro, rd, t_min).min(-1)
        return t, idx.to(torch.int32)

    monkeypatch.setattr(intersect, "sphere_sweep", plain)
    want = render_block_stats(scene, cfg, ids, 3, 1)
    assert float(want[1][-1]) < float(want[1][0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
