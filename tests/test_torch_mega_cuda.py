"""The CUDA segment kernel vs its plain version on the card at every
group size (lanes per ray), every group size bitwise equal to one lane per
ray, and the two gradient routes through it.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_mega_cuda.py``.
"""

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import rng
from torch_port_cases import assert_close, mesh_recipe, shaped_recipe


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def segments(device, recipe, nee):
    """[(state, u, ls, tables, seg)]: each segment of a 4,096-ray render of
    the recipe's scene, its state from the plain version's previous
    segment, light samples drawn at random."""
    scene = recipe(SceneBuilder).build(64, 64, device=device)
    cfg = RenderConfig(width=64, height=64, spp=1, max_bounces=6,
                       enable_dof=False, enable_nee=nee, mega_sort_after=2)
    ids = torch.arange(4096, device=device, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(0, device), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    tables = mega.prepare_tables(scene, cfg)
    state = torch.cat([ro.T, rd.T, torch.ones((3, 4096), device=device),
                       torch.full((1, 4096), -1.0, device=device),
                       torch.ones((1, 4096), device=device)]).contiguous()
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for b, nf in mega.segment_plan(cfg)[0]:
        u = torch.cat([rng.tagged_uniform_planes(keys, b + i, 8)
                       for i in range(nf)]).contiguous()
        ls = torch.rand((10 * nf, 4096), device=device, generator=gen)
        ls[9::10] += 0.05                       # positive area pdfs
        seg = mega.Segment.of(cfg, tables.meta, b, nf)
        out.append((state, u, ls, tables, seg))
        state = mega.mega_segment_plain(state, u, ls, tables, seg)[0]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("group", mega.GROUPS)
@pytest.mark.parametrize("recipe", [mesh_recipe, shaped_recipe])
@pytest.mark.parametrize("nee", [True, False])
def test_kernel_matches_plain(device, recipe, nee, group):
    for state, u, ls, tables, seg in segments(device, recipe, nee):
        before = mega.KERNEL_LAUNCHES
        k_state, k_rad = mega.mega_segment_cuda(state, u, ls, tables, seg,
                                                group=group)
        assert mega.KERNEL_LAUNCHES == before + 1
        p_state, p_rad = mega.mega_segment_plain(state, u, ls, tables, seg)
        k_rad, p_rad = k_rad.cpu().numpy(), p_rad.cpu().numpy()
        assert (k_rad[3:] != p_rad[3:]).mean() < 0.002
        assert_close(p_rad[0:3].T, k_rad[0:3].T)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", [mesh_recipe, shaped_recipe])
def test_groups_bitwise_equal(device, recipe):
    """Every group size gives the state and radiance/records of one lane
    per ray bit for bit (the winner does not depend on visit order); the
    rule's own pick goes through ``mega_segment``."""
    for state, u, ls, tables, seg in segments(device, recipe, True):
        ref = mega.mega_segment_cuda(state, u, ls, tables, seg, group=1)
        runs = [mega.mega_segment_cuda(state, u, ls, tables, seg, group=g)
                for g in mega.GROUPS[1:]]
        runs.append(mega.mega_segment(state, u, ls, tables, seg))
        for got in runs:
            for r, k in zip(ref, got):
                assert torch.equal(r.view(torch.int32), k.view(torch.int32))


@pytest.mark.cuda
def test_grad_modes_agree(device):
    """kernel-value and replay-value gradients (albedo, mesh v0) of one
    render on the card: the same replay of the same kernel records, so
    they agree to rtol 1e-4; each step makes one set of segment launches
    with records."""
    import dataclasses

    from offline_raytracer_tpu_torch.render import render_block

    scene = mesh_recipe(SceneBuilder).build(64, 64, device=device)
    cfg = RenderConfig(width=64, height=64, spp=1, max_bounces=6,
                       enable_dof=False)
    ids = torch.arange(4096, device=device, dtype=torch.int32)
    grads = []
    for mode in ("kernel-value", "replay-value"):
        kd = scene.materials.diffuse.clone().requires_grad_(True)
        v0 = scene.triangles.v0.clone().requires_grad_(True)
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, diffuse=kd),
            triangles=dataclasses.replace(scene.triangles, v0=v0))
        before = mega.KERNEL_LAUNCHES
        loss = render_block(sc, cfg.replace(grad_mode=mode), ids, 0, 1).mean()
        grads.append(torch.autograd.grad(loss, (kd, v0)))
        assert mega.KERNEL_LAUNCHES - before == len(mega.segment_plan(cfg)[0])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-7)
