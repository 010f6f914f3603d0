"""The port's checkpoint/resume and profiling (``utils/checkpoint.py``,
``utils/profiling.py``, ``render.render_image_resumable``,
``diff.optimize(checkpoint_dir=)``), modelled on
``tests/test_checkpoint.py``, and checkpoints crossing between the two
packages in both directions.

The resume contract: an interrupted render resumed from its checkpoint is
bitwise the uninterrupted render (the same launches on the same
counter-based draws). A render resumed from the JAX package's checkpoint
gives the JAX uninterrupted image within ``torch_port_cases.assert_close``
(the two packages' images agree to float32 rounding, not bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

from offline_raytracer_tpu.config import RenderConfig as JaxConfig
from offline_raytracer_tpu.render import (
    render_image_resumable as jax_resumable)
from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu.utils import checkpoint as jax_ckpt
from offline_raytracer_tpu_torch import RenderConfig, diff
from offline_raytracer_tpu_torch.render import (
    render_block, render_block_stats, render_image, render_image_resumable,
    tile_pixel_ids)
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import checkpoint as ckpt
from offline_raytracer_tpu_torch.utils import profiling
from offline_raytracer_tpu_torch.utils.profiling import (
    RenderMeter, device_trace)
from torch_port_cases import analytic_recipe, assert_close

torch.set_num_threads(2)

CFG = dict(width=16, height=16, spp=8, max_bounces=3, enable_dof=False,
           use_bvh=False, use_pallas=False)


@pytest.fixture(scope="module")
def scene():
    return analytic_recipe(SceneBuilder).build(64, 64, device="cpu")


def test_accum_roundtrip(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    acc = np.random.default_rng(0).random((256, 3)).astype(np.float32)
    ckpt.save_accum(path, acc, 5, cfg)
    got, spp = ckpt.load_accum(path, cfg)
    np.testing.assert_array_equal(got, acc)
    assert spp == 5
    assert not list(tmp_path.glob("*.tmp"))


def test_accum_config_mismatch_rejected(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    ckpt.save_accum(path, np.zeros((256, 3), np.float32), 5, cfg)
    assert ckpt.load_accum(path, cfg.replace(seed=99)) is None
    assert ckpt.load_accum(path, cfg.replace(max_bounces=4)) is None
    (tmp_path / "junk.npz").write_bytes(b"not a checkpoint")
    assert ckpt.load_accum(str(tmp_path / "junk.npz"), cfg) is None
    assert ckpt.load_accum(str(tmp_path / "absent.npz"), cfg) is None


def test_accum_perf_knob_change_resumes(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    ckpt.save_accum(path, np.zeros((256, 3), np.float32), 5, cfg)
    cfg2 = cfg.replace(traversal="jnp", ray_batch=1 << 10, use_pallas=True,
                       grad_mode="replay-value", replay_tiers=((2, 4),))
    assert ckpt.load_accum(path, cfg2) is not None


def _interrupted(scene, cfg, path, resumable, checkpoint):
    """tests/test_checkpoint.py's surgery with one package's resumable
    render and checkpoint module: a 4-spp run, its checkpoint relabelled
    as a paused run of cfg.spp."""
    half = cfg.replace(spp=4)
    resumable(scene, half, path, checkpoint_every_spp=4)
    state = checkpoint.load_accum(path, half)
    assert state is not None and state[1] == 4
    checkpoint.save_accum(path, state[0], 4, cfg)


def test_resume_is_bitwise_uninterrupted(scene, tmp_path):
    cfg = RenderConfig(**CFG)
    straight = render_image_resumable(scene, cfg, str(tmp_path / "a.npz"),
                                      checkpoint_every_spp=4)
    path = str(tmp_path / "b.npz")
    _interrupted(scene, cfg, path, render_image_resumable, ckpt)
    meter = RenderMeter()
    resumed = render_image_resumable(scene, cfg, path, checkpoint_every_spp=4,
                                     meter=meter)
    np.testing.assert_array_equal(resumed, straight)
    assert meter.launches == 1 and meter.paths == 256 * 4
    assert ckpt.load_accum(path, cfg)[1] == 8
    # the tile-order renderer, chunked otherwise, agrees to float rounding
    np.testing.assert_allclose(resumed, render_image(scene, cfg), rtol=1e-4,
                               atol=1e-6)


def test_render_image_meter_changes_nothing(scene):
    """render_image with a meter: the same image, one launch per block and
    sample chunk, the rays the alive counts give."""
    cfg = RenderConfig(**CFG).replace(ray_batch=128)
    meter = RenderMeter()
    img = render_image(scene, cfg, meter=meter)
    np.testing.assert_array_equal(img, render_image(scene, cfg))
    assert meter.launches == 2 * 8 and meter.paths == 256 * 8
    order = torch.from_numpy(tile_pixel_ids(16, 16))
    segments = 0.0
    for block in (order[:128], order[128:]):
        for s in range(8):
            alive = render_block_stats(scene, cfg, block, s, 1)[1]
            segments += 128 + alive.double().sum().item()
    assert meter.segments == segments
    assert meter.shadow_rays > 0 and meter.mrays_per_s() > 0


def test_phase_timer_and_meter():
    # named phases: the recorder's spans, totalled per name
    with profiling.recording():
        with profiling.span("a"):
            pass
        with profiling.span("a"):
            pass
    totals = profiling.span_totals(profiling.flush()["spans"])
    assert totals["a"]["count"] == 2 and totals["a"]["seconds"] >= 0

    m = RenderMeter()
    m.add_launch(100, [80.0, 60.0, 0.0], nee_enabled=True, seconds=0.5)
    d = m.as_dict()
    assert d["paths"] == 100
    assert d["segments"] == 240            # 100 camera + 140 bounce segments
    assert d["shadow_rays"] == 240         # camera hit + bounces but the last
    assert d["rays"] == 480 and d["mrays_per_s"] > 0
    assert m.bounce_histogram == [80.0, 60.0, 0.0]
    # float64 sums: exact past 2**24 rays, where float32 rounds
    big = RenderMeter()
    for _ in range(3):
        big.add_launch(1 << 24, np.array([(1 << 24) - 1, 3], np.float32),
                       nee_enabled=False, seconds=1.0)
    assert big.segments == 3 * ((1 << 25) + 2)


def test_device_trace_writes_a_trace(scene, tmp_path):
    with device_trace(str(tmp_path / "trace")):
        render_block(scene, RenderConfig(**CFG), torch.arange(
            16, dtype=torch.int32), 0, 1)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with device_trace(None):
        pass


def test_opt_state_roundtrip(tmp_path):
    w = torch.arange(4.0, requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-2)
    for _ in range(2):
        w.grad = torch.ones(4)
        opt.step()
    d = str(tmp_path / "opt")
    ckpt.save_opt_state(d, 3, {"w": w}, opt.state_dict())
    ckpt.save_opt_state(d, 1, {"w": w}, opt.state_dict())
    assert ckpt.latest_opt_step(d) == 3
    assert ckpt.latest_opt_step(str(tmp_path / "none")) is None
    p2, s2 = ckpt.load_opt_state(d, 3)
    np.testing.assert_array_equal(p2["w"].numpy(), w.detach().numpy())
    w2 = torch.zeros(4, requires_grad=True)
    opt2 = torch.optim.Adam([w2], lr=1e-2)
    opt2.load_state_dict(s2)
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(opt2.state[w2][k], opt.state[w][k]), k


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path):
    """A render paused by the JAX package and resumed by the port gives the
    JAX uninterrupted image."""
    js = analytic_recipe(JaxBuilder).build(64, 64)
    jcfg = JaxConfig(**CFG)
    straight = jax_resumable(js, jcfg, str(tmp_path / "j.npz"),
                             checkpoint_every_spp=4)
    path = str(tmp_path / "x.npz")
    _interrupted(js, jcfg, path, jax_resumable, jax_ckpt)
    resumed = render_image_resumable(scene, RenderConfig(**CFG), path,
                                     checkpoint_every_spp=4)
    assert_close(np.asarray(straight).reshape(-1, 3), resumed.reshape(-1, 3))
    # the port's resumed sum holds the JAX package's first 4 spp exactly
    assert ckpt.load_accum(path, RenderConfig(**CFG))[1] == 8


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = RenderConfig(**CFG).replace(seed=3)
    path = str(tmp_path / "p.npz")
    acc = np.random.default_rng(1).random((256, 3)).astype(np.float32)
    ckpt.save_accum(path, acc, 6, cfg)
    jcfg = JaxConfig(**CFG).replace(seed=3)
    got, spp = jax_ckpt.load_accum(path, jcfg)
    np.testing.assert_array_equal(got, acc)
    assert spp == 6
    assert jax_ckpt.load_accum(path, jcfg.replace(seed=4)) is None
    assert jax_ckpt.load_accum(path, jcfg.replace(ray_batch=64)) is not None


def test_optimize_resumes_from_checkpoint_dir(scene, tmp_path):
    """An inverse-rendering run stopped after 2 of 4 steps and restarted on
    the same checkpoint_dir gives the uninterrupted run's last losses and
    params (rtol 1e-6)."""
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=2,
                       enable_dof=False)
    ids = torch.arange(64, dtype=torch.int32)
    target = render_block(scene, cfg, ids, 100, 4)
    wrong = scene.materials.diffuse.clone()
    wrong[1] = torch.tensor((0.1, 0.8, 0.8))
    sc = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=wrong))
    run = lambda d, steps: diff.optimize(  # noqa: E731
        sc, cfg, target, ids, diff.material_params(sc), steps=steps, lr=0.1,
        checkpoint_dir=str(tmp_path / d), checkpoint_every=2)
    p_full, l_full = run("full", 4)
    _, l_first = run("cut", 2)
    p_res, l_res = run("cut", 4)
    assert ckpt.latest_opt_step(str(tmp_path / "cut")) == 4
    np.testing.assert_allclose(l_first + l_res, l_full, rtol=1e-6)
    assert len(l_res) == 2
    for k in p_full:
        np.testing.assert_allclose(p_res[k].numpy(), p_full[k].numpy(),
                                   rtol=1e-6)
