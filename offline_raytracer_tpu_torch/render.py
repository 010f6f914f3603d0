"""Render loop (counterpart of ``offline_raytracer_tpu/render.py``).

The (pixel x sample) space is cut into ray batches; each batch traces one
sample per pixel through the route ``_paths_fn`` picks from the config and
the scene, never from the device:

- the segment route (``ops/mega.render_paths_mega``: fused bounce
  segments) when ``traversal`` is "auto" or "mega", ``use_bvh`` and
  ``use_pallas`` are set and the scene fits the segment kernel's tables
  (``mega.mega_ok``);
- otherwise the wavefront route (``integrator.trace_paths``), whose
  triangle queries go through the cull or packet kernel, or the plain dense
  sweep, as ``ops/traverse.pick_tri_hit`` says; without ``use_bvh`` it is
  the brute-force sweep over every primitive.

(The JAX package leaves the segment route on its CPU backend; the port
runs the same route on the CPU with the plain versions.) Under autograd the
segment route is differentiable through the replay (``replay.py``), as
``cfg.grad_mode`` says; without a gradient to take it is the plain segment
call. ``render_image_diff`` is the differentiable single-call render;
``render_image_resumable`` checkpoints the accumulation
(``utils/checkpoint.py``) and resumes it bitwise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.integrator import (
    make_brute_trace_fn, trace_paths, wants_grad)
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.ops.traverse import (
    make_bvh_occlusion_fn, make_bvh_trace_fn, tri_tables)
from offline_raytracer_tpu_torch.replay import mega_paths_diff, replay_paths
from offline_raytracer_tpu_torch.scene.types import Scene
from offline_raytracer_tpu_torch.utils import profiling, rng


def _trace_builder(scene: Scene, cfg: RenderConfig):
    """(closest_hit_fn, occluded_fn or None): the BVH queries when the
    scene carries a BVH and ``use_bvh`` is set, the brute-force sweep
    otherwise."""
    if cfg.use_bvh and scene.tri_bvh is not None:
        tables = tri_tables(scene.tri_bvh)
        return (make_bvh_trace_fn(scene, cfg, tables),
                make_bvh_occlusion_fn(scene, cfg, tables))
    return make_brute_trace_fn(scene, cfg), None


def _mega_active(scene: Scene, cfg: RenderConfig) -> bool:
    """Route through the segment kernel (ops/mega.py)?"""
    return (cfg.traversal in ("auto", "mega") and cfg.use_pallas
            and cfg.use_bvh and mega.mega_ok(scene, cfg))


def _paths_fn(scene: Scene, cfg: RenderConfig,
              tables: mega.MegaTables | None = None):
    """Path-trace callable (ro, rd, keys, collect_stats) -> radiance
    [, alive per bounce]: the segment route when the config and scene
    qualify, else the wavefront. ``tables``: the segment route's
    ``mega.prepare_tables(scene, cfg)``, built here (without grad) if None.

    On the segment route, stats and renders with no gradient to take are
    the plain segment call; a differentiated render takes the replay
    (``grad_mode="replay-value"``) or the kernel's value with the replay's
    gradient ("kernel-value")."""
    if _mega_active(scene, cfg):
        if tables is None:
            with torch.no_grad():
                tables = mega.prepare_tables(scene, cfg)

        def f(ro, rd, keys, collect_stats=False):
            if collect_stats or not wants_grad(scene, ro, rd):
                return mega.render_paths_mega(scene, cfg, ro, rd, keys,
                                              collect_stats=collect_stats,
                                              tables=tables)
            if cfg.grad_mode == "replay-value":
                return replay_paths(scene, cfg, ro, rd, keys, tables)
            return mega_paths_diff(scene, cfg, ro, rd, keys, tables)
        return f

    trace_fn, occl_fn = _trace_builder(scene, cfg)

    def f(ro, rd, keys, collect_stats=False):
        return trace_paths(scene, cfg, trace_fn, ro, rd, keys,
                           collect_stats=collect_stats, occl_fn=occl_fn)
    return f


@profiling.spanned("render.block")
def _accumulate(paths, scene, cfg, pixel_ids, sample_lo, n_samples,
                collect_stats):
    dev = pixel_ids.device
    root = rng.render_key(cfg.seed, dev)
    accum = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=dev)
    alive_acc = torch.zeros((cfg.max_bounces,), dtype=torch.float32,
                            device=dev)
    for k in range(n_samples):
        with profiling.span("render.camera"):
            keys = rng.pixel_sample_keys(
                root, pixel_ids, torch.full_like(pixel_ids, sample_lo + k))
            ro, rd = generate_rays(scene.camera, cfg, pixel_ids, keys)
        out = paths(ro, rd, keys, collect_stats=collect_stats)
        if collect_stats:
            out, alive = out
            alive_acc = alive_acc + alive
        accum = accum + out
    return accum / n_samples, alive_acc


def render_block(scene: Scene, cfg: RenderConfig, pixel_ids, sample_lo: int,
                 n_samples: int, tables: mega.MegaTables | None = None):
    """Mean radiance (P, 3) of ``n_samples`` paths per pixel id.
    ``tables``: see ``_paths_fn``."""
    return _accumulate(_paths_fn(scene, cfg, tables), scene, cfg, pixel_ids,
                       sample_lo, n_samples, False)[0]


def render_block_stats(scene: Scene, cfg: RenderConfig, pixel_ids,
                       sample_lo: int, n_samples: int,
                       tables: mega.MegaTables | None = None):
    """render_block + per-bounce alive counts summed over the samples."""
    return _accumulate(_paths_fn(scene, cfg, tables), scene, cfg, pixel_ids,
                       sample_lo, n_samples, True)


def tile_pixel_ids(width: int, height: int, tile: int = 32) -> np.ndarray:
    """All pixel ids in 32x32-tile-major order, so a batch's neighbouring
    rays start in the same region of the image."""
    ids = np.arange(width * height, dtype=np.int32)
    x = ids % width
    y = ids // width
    key = (y // tile).astype(np.int64) * (width // tile + 1) + (x // tile)
    return ids[np.argsort(key, kind="stable")]


def _launch(paths, scene, cfg, ids, sample_lo, k, meter):
    """Mean radiance (P, 3) of samples [sample_lo, sample_lo + k) of
    pixels ``ids``. With a ``utils.profiling.RenderMeter`` the launch
    collects the alive counts and feeds the meter its rays and seconds,
    the clock closed by a sync when the scene is on the card; without one
    nothing waits."""
    if meter is None:
        return _accumulate(paths, scene, cfg, ids, sample_lo, k, False)[0]
    t0 = time.time()
    out, alive = _accumulate(paths, scene, cfg, ids, sample_lo, k, True)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    meter.add_launch(ids.shape[0] * k, alive.cpu().numpy(),
                     cfg.enable_nee and scene.n_lights > 0, time.time() - t0)
    return out


def render_image(scene: Scene, cfg: RenderConfig, progress: bool = False,
                 meter=None) -> np.ndarray:
    """Full render -> (H, W, 3) float32, row 0 = top, on the scene's
    device. ``meter``: an optional ``utils.profiling.RenderMeter`` fed with
    every launch's rays and seconds."""
    dev = scene.device
    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, max(1, cfg.ray_batch))
    spp_chunk = max(1, min(cfg.spp, cfg.ray_batch // block))
    all_ids = torch.from_numpy(tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    img = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    paths = _paths_fn(scene, cfg)       # scene tables built once
    for start in range(0, n_pixels, block):
        ids = all_ids[start:min(start + block, n_pixels)]
        acc = None
        done = 0
        while done < cfg.spp:
            k = min(spp_chunk, cfg.spp - done)
            out = _launch(paths, scene, cfg, ids, done, k, meter)
            acc = out * k if acc is None else acc + out * k
            done += k
            if progress:
                print(f"pixels [{start}:{start + ids.shape[0]}) "
                      f"spp {done}/{cfg.spp}", flush=True)
        img[ids.long()] = acc / cfg.spp
    # pixel row 0 is the bottom scanline; flip to image order
    return img.cpu().numpy().reshape(cfg.height, cfg.width, 3)[::-1]


def render_image_resumable(scene: Scene, cfg: RenderConfig,
                           checkpoint_path: str,
                           checkpoint_every_spp: int = 16,
                           progress: bool = False, meter=None) -> np.ndarray:
    """Full render with a durable accumulation (``utils/checkpoint.py``)
    -> (H, W, 3) float32, row 0 = top.

    Samples advance spp-major (all pixels together, in natural pixel
    order), and the running float32 sum is checkpointed after every
    ``checkpoint_every_spp`` samples. A restart resumes at the recorded
    sample index; the sample keys are counter-based and each launch's
    batches are the same, so the image is bitwise the uninterrupted one.
    ``meter``: as in ``render_image``."""
    from offline_raytracer_tpu_torch.utils import checkpoint as ckpt

    dev = scene.device
    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, max(1, cfg.ray_batch))

    state = ckpt.load_accum(checkpoint_path, cfg)
    if state is not None:
        accum, spp_done = state
        if progress:
            print(f"resumed {checkpoint_path} at spp {spp_done}", flush=True)
    else:
        accum = np.zeros((n_pixels, 3), np.float32)
        spp_done = 0

    paths = _paths_fn(scene, cfg)       # scene tables built once
    while spp_done < cfg.spp:
        k = min(checkpoint_every_spp, cfg.spp - spp_done)
        for start in range(0, n_pixels, block):
            ids = np.arange(start, min(start + block, n_pixels),
                            dtype=np.int32)
            out = _launch(paths, scene, cfg, torch.from_numpy(ids).to(dev),
                          spp_done, k, meter)
            accum[ids] += out.cpu().numpy() * k
        spp_done += k
        ckpt.save_accum(checkpoint_path, accum, spp_done, cfg)
        if progress:
            print(f"spp {spp_done}/{cfg.spp} checkpointed", flush=True)

    img = accum / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3)[::-1]


def render_image_diff(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Differentiable single-call render for small images (inverse
    rendering); the JAX package's ``render_image_jnp``.

    Returns an (H, W, 3) tensor, row 0 = top, with autograd attached to
    the scene tensors that require grad, on whichever route the config
    and scene take (``_paths_fn``).
    """
    n_pixels = cfg.width * cfg.height
    pixel_ids = torch.arange(n_pixels, dtype=torch.int32,
                             device=scene.device)
    out = render_block(scene, cfg, pixel_ids, 0, cfg.spp)
    return out.reshape(cfg.height, cfg.width, 3).flip(0)
