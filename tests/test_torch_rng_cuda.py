"""The threefry kernel (``csrc/threefry.cu``) vs the plain draws on the
card: planes and per-ray keys bit for bit equal to the plain version's on
the same words moved to the CPU, a whole render equal with the plain route
forced, and the launches a render makes.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_rng_cuda.py``.
"""

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.render import render_block_stats
from offline_raytracer_tpu_torch.utils import rng

SIZE = 64


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _words(R, seed):
    """(R, 2) int64 keys of random 32-bit words, every other one with its
    top bit set."""
    w = np.random.RandomState(seed).randint(0, 1 << 32, (R, 2),
                                            dtype=np.uint64)
    w[::2] |= np.uint64(1 << 31)
    return torch.from_numpy(w.astype(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 127, 128, 129, 262144])
@pytest.mark.parametrize("tag_lo,n_tags,n", [(0, 1, 8), (11, 1, 8),
                                             (rng.CAMERA_TAG, 1, 4),
                                             (0, 9, 8), (11, 2, 5)])
def test_planes_bitwise(device, R, tag_lo, n_tags, n):
    keys = _words(R, R + n_tags)
    before = rng.KERNEL_LAUNCHES
    got = rng.uniform_planes(keys.to(device), tag_lo, n_tags, n)
    assert rng.KERNEL_LAUNCHES == before + 1
    assert got.shape == (n_tags * n, R) and got.dtype == torch.float32
    want = rng.uniform_planes_plain(keys, tag_lo, n_tags, n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 1000, 262144])
@pytest.mark.parametrize("wide", [(False, False), (True, False),
                                  (False, True)])
def test_pixel_sample_keys_bitwise(device, R, wide):
    # int64 ids span 40 bits: fold_in reads their low 32
    rs = np.random.RandomState(R)
    pix = torch.from_numpy(rs.randint(0, 1 << 40 if wide[0] else 1 << 31, R,
                                      dtype=np.int64))
    smp = torch.from_numpy(rs.randint(-(1 << 40) if wide[1] else -(1 << 31),
                                      1 << 40 if wide[1] else 1 << 31, R,
                                      dtype=np.int64))
    pix = pix if wide[0] else pix.to(torch.int32)
    smp = smp if wide[1] else smp.to(torch.int32)
    root = rng.render_key(2**32 - 1)
    before = rng.KERNEL_LAUNCHES
    got = rng.pixel_sample_keys(root.to(device), pix.to(device),
                                smp.to(device))
    assert rng.KERNEL_LAUNCHES == before + 1
    want = rng.pixel_sample_keys_plain(root, pix, smp)
    assert torch.equal(got.cpu(), want)
    # strided ids and a broadcast sample id
    got = rng.pixel_sample_keys(root.to(device), pix.to(device)[::3],
                                torch.tensor(7, device=device))
    want = rng.pixel_sample_keys_plain(root, pix[::3], torch.tensor(7))
    assert torch.equal(got.cpu(), want)


def _bunny(device):
    import chip_smoke

    scene = chip_smoke.bunny_stand_in(device, SIZE)
    cfg = RenderConfig(width=SIZE, height=SIZE, max_bounces=8,
                       enable_dof=False, ray_batch=SIZE * SIZE)
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32, device=device)
    return scene, cfg, ids, mega.prepare_tables(scene, cfg)


@pytest.mark.cuda
def test_render_bitwise_with_plain_route(device, monkeypatch):
    """A whole render of the bunny stand-in: radiance and alive counts
    with the kernel equal those with the plain draws forced on the card."""
    scene, cfg, ids, tables = _bunny(device)
    rad, alive = render_block_stats(scene, cfg, ids, 3, 2, tables)
    monkeypatch.setattr(rng, "uniform_planes_cuda", rng.uniform_planes_plain)
    monkeypatch.setattr(rng, "pixel_sample_keys_cuda",
                        rng.pixel_sample_keys_plain)
    before = rng.KERNEL_LAUNCHES
    p_rad, p_alive = render_block_stats(scene, cfg, ids, 3, 2, tables)
    assert rng.KERNEL_LAUNCHES == before
    assert float(alive[0]) > 0 and float(rad.sum()) > 0
    assert torch.equal(rad, p_rad)
    assert torch.equal(alive, p_alive)


@pytest.mark.cuda
def test_launches_per_block(device, monkeypatch):
    """One kernel launch per segment and two per sample (the keys and the
    camera's uniforms); no plain draw on the card."""
    scene, cfg, ids, tables = _bunny(device)
    n_segs = len(mega.segment_plan(cfg)[0])

    def refuse(*args):
        raise AssertionError("a plain draw ran on the card")

    monkeypatch.setattr(rng, "uniform_planes_plain", refuse)
    monkeypatch.setattr(rng, "pixel_sample_keys_plain", refuse)
    before = rng.KERNEL_LAUNCHES
    render_block_stats(scene, cfg, ids, 0, 3, tables)
    assert rng.KERNEL_LAUNCHES - before == 3 * (n_segs + 2)
