"""Render loop (counterpart of ``offline_raytracer_tpu/render.py``).

The (pixel x sample) space is cut into ray batches; each batch traces one
sample per pixel through ``ops/mega.render_paths_mega`` on the device the
scene lives on. ``render_image_resumable``, ``render_image_jnp`` (the
differentiable single-call render) and the checkpoint path are not ported
yet (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.types import Scene
from offline_raytracer_tpu_torch.utils import rng


def _sample(scene, cfg, pixel_ids, root, sample_idx, collect_stats, tables):
    keys = rng.pixel_sample_keys(
        root, pixel_ids, torch.full_like(pixel_ids, sample_idx))
    ro, rd = generate_rays(scene.camera, cfg, pixel_ids, keys)
    return mega.render_paths_mega(scene, cfg, ro, rd, keys,
                                  collect_stats=collect_stats, tables=tables)


def render_block(scene: Scene, cfg: RenderConfig, pixel_ids, sample_lo: int,
                 n_samples: int, tables: mega.MegaTables | None = None):
    """Mean radiance (P, 3) of ``n_samples`` paths per pixel id.
    ``tables``: ``mega.prepare_tables(scene, cfg)``, built here if None."""
    root = rng.render_key(cfg.seed, pixel_ids.device)
    if tables is None:
        tables = mega.prepare_tables(scene, cfg)
    accum = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=pixel_ids.device)
    for k in range(n_samples):
        accum = accum + _sample(scene, cfg, pixel_ids, root, sample_lo + k,
                                False, tables)
    return accum / n_samples


def render_block_stats(scene: Scene, cfg: RenderConfig, pixel_ids,
                       sample_lo: int, n_samples: int,
                       tables: mega.MegaTables | None = None):
    """render_block + per-bounce alive counts summed over the samples."""
    dev = pixel_ids.device
    root = rng.render_key(cfg.seed, dev)
    if tables is None:
        tables = mega.prepare_tables(scene, cfg)
    accum = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=dev)
    alive_acc = torch.zeros((cfg.max_bounces,), dtype=torch.float32,
                            device=dev)
    for k in range(n_samples):
        radiance, alive = _sample(scene, cfg, pixel_ids, root,
                                  sample_lo + k, True, tables)
        accum = accum + radiance
        alive_acc = alive_acc + alive
    return accum / n_samples, alive_acc


def tile_pixel_ids(width: int, height: int, tile: int = 32) -> np.ndarray:
    """All pixel ids in 32x32-tile-major order, so a batch's neighbouring
    rays start in the same region of the image."""
    ids = np.arange(width * height, dtype=np.int32)
    x = ids % width
    y = ids // width
    key = (y // tile).astype(np.int64) * (width // tile + 1) + (x // tile)
    return ids[np.argsort(key, kind="stable")]


def render_image(scene: Scene, cfg: RenderConfig,
                 progress: bool = False) -> np.ndarray:
    """Full render -> (H, W, 3) float32, row 0 = top, on the scene's
    device."""
    dev = scene.device
    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, max(1, cfg.ray_batch))
    spp_chunk = max(1, min(cfg.spp, cfg.ray_batch // block))
    all_ids = torch.from_numpy(tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    img = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    tables = mega.prepare_tables(scene, cfg)
    for start in range(0, n_pixels, block):
        ids = all_ids[start:min(start + block, n_pixels)]
        acc = None
        done = 0
        while done < cfg.spp:
            k = min(spp_chunk, cfg.spp - done)
            out = render_block(scene, cfg, ids, done, k, tables)
            acc = out * k if acc is None else acc + out * k
            done += k
            if progress:
                print(f"pixels [{start}:{start + ids.shape[0]}) "
                      f"spp {done}/{cfg.spp}", flush=True)
        img[ids.long()] = acc / cfg.spp
    # pixel row 0 is the bottom scanline; flip to image order
    return img.cpu().numpy().reshape(cfg.height, cfg.width, 3)[::-1]
