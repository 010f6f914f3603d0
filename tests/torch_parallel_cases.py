"""Rank functions of the parallel tests (not collected by pytest).

``parallel.shard.run_ranks`` runs each in spawned processes, which import
this module by name: it imports no jax, so a rank starts with torch and the
port alone. Each builds its scene on the CPU from a recipe and returns
numpy arrays.
"""

import dataclasses
import time

import numpy as np
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.parallel import ring, shard
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from torch_port_cases import (
    analytic_recipe, far_origin_recipe, far_origin_rays, mesh_recipe)

CFG = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                   enable_dof=False)
MESH_TRIS = 1152
# the card's cases: a mesh of 71 leaves at 64x64
CARD_TRIS = 9000
CARD_CFG = RenderConfig(width=64, height=64, spp=2, max_bounces=4,
                        enable_dof=False)
SHADOW_RAYS = 256
LIGHT = np.array([1.5, -1.5, 3.0], np.float32)   # mesh_recipe's light
LIGHT_R = 0.4                                    # and its radius


def scene(name, device="cpu"):
    recipe = {"mesh": lambda B: mesh_recipe(B, MESH_TRIS),
              "card": lambda B: mesh_recipe(B, CARD_TRIS),
              "analytic": analytic_recipe,
              "far": far_origin_recipe}[name]
    w, h = (CARD_CFG.width, CARD_CFG.height) if name == "card" else (16, 16)
    return recipe(SceneBuilder).build(w, h, device=device)


def pixel_ids(cfg=CFG, device="cpu"):
    return torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                        device=device)


def shadow_rays():
    """Shadow-ray-shaped queries of the mesh scene (tests/test_parallel.py
    :158-166): points near the floor toward the light's centre, t_far
    short of the light sphere -> (ro, rd, t_far) float32 numpy."""
    rs = np.random.RandomState(0)
    ro = (rs.uniform(-1, 1, (SHADOW_RAYS, 3)).astype(np.float32)
          * np.array([0.6, 0.6, 0.4], np.float32))
    to_light = LIGHT - ro
    dist = np.linalg.norm(to_light, axis=-1)
    return (ro, (to_light / dist[:, None]).astype(np.float32),
            dist - np.float32(LIGHT_R + 0.1))


def far_alive(R):
    """The alive mask of the far-origin case: every 6th lane dead."""
    alive = np.ones(R, bool)
    alive[1::6] = False
    return alive


def get_params(sc):
    return {"diffuse": sc.materials.diffuse, "center": sc.spheres.center}


def set_params(sc, p):
    return dataclasses.replace(
        sc, materials=dataclasses.replace(sc.materials, diffuse=p["diffuse"]),
        spheres=dataclasses.replace(sc.spheres, center=p["center"]))


def sharded_renders(group):
    """The sharded render of the mesh and analytic scenes and the ring
    render of the mesh scene, each as every rank holds it."""
    mesh = scene("mesh")
    return {
        "mesh": shard.render_block_sharded(mesh, CFG, group,
                                           pixel_ids()).numpy(),
        "analytic": shard.render_block_sharded(scene("analytic"), CFG, group,
                                               pixel_ids()).numpy(),
        "ring": ring.render_block_ring(mesh, CFG, group, pixel_ids()).numpy(),
    }


def all_cases(group):
    """sharded_renders, plus the sharded gradient step, ring occlusion of
    shadow rays, the ring's closest hits of the far-origin rays and the
    slots each rank's shard holds."""
    out = sharded_renders(group)
    an = scene("analytic")
    loss, grads = shard.grad_step_sharded(
        an, CFG, group, pixel_ids(), torch.zeros((256, 3)), get_params,
        set_params)
    out["loss"] = loss.numpy()
    out["grads"] = {k: g.numpy() for k, g in grads.items()}

    mesh = scene("mesh")
    tables = ring.prepare_ring_shards(mesh, group)
    out["slots"] = int(tables.tri.shape[0])
    ro, rd, tf = (torch.from_numpy(x) for x in shadow_rays())
    occl = ring.make_ring_occlusion_fn(mesh, CFG, tables, group)
    occ = occl(*(shard.rank_block(group, x) for x in (ro, rd, tf)))
    out["occluded"] = shard.all_gather(group, occ.to(torch.int32)).numpy() > 0

    far = scene("far")
    ro, rd = (torch.from_numpy(x) for x in far_origin_rays())
    alive = torch.from_numpy(far_alive(ro.shape[0]))
    trace = ring.make_ring_trace_fn(
        dataclasses.replace(far, tri_bvh=None), CFG,
        ring.prepare_ring_shards(far, group), group)
    hit = trace(*(shard.rank_block(group, x) for x in (ro, rd, alive)))
    out["far_valid"] = shard.all_gather(
        group, hit.valid.to(torch.int32)).numpy() > 0
    out["far_t"] = shard.all_gather(group, hit.t).numpy()
    return out


def fail_on_rank_1(group):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return shard.all_reduce_sum(group, torch.ones(1)).numpy()


def hang_on_rank_1(group):
    """Rank 1 never returns; rank 0 waits in a collective for it."""
    if group.rank == 1:
        time.sleep(3600)
    return shard.all_reduce_sum(group, torch.ones(1)).numpy()


def card_cases(group):
    """On the rank's card: the sharded render of the card mesh, and its
    ring render through the cull and through the packet route, each with
    the kernel launches it made on this rank."""
    from chip_smoke import take_counts

    sc = scene("card", group.device)
    ids = pixel_ids(CARD_CFG, group.device)
    out = {}
    for name, fn in (
            ("sharded", lambda: shard.render_block_sharded(
                sc, CARD_CFG, group, ids)),
            ("cull", lambda: ring.render_block_ring(
                sc, CARD_CFG.replace(traversal="auto"), group, ids)),
            ("packet", lambda: ring.render_block_ring(
                sc, CARD_CFG.replace(traversal="packet"), group, ids))):
        take_counts()
        out[name] = fn().cpu().numpy()
        out[name + "_launches"] = take_counts()
    return out


def traced_sharded_render(group):
    """The sharded render of the mesh scene with the recorder on (its spans
    and counters, the gathered image's bytes), then, with the recorder
    off, the alive counts of this rank's own block
    (``render_block_stats``) and its paths."""
    from offline_raytracer_tpu_torch.render import render_block_stats
    from offline_raytracer_tpu_torch.utils import profiling

    mesh = scene("mesh")
    ids = pixel_ids()
    with profiling.recording():
        img = shard.render_block_sharded(mesh, CFG, group, ids)
    got = profiling.flush()
    own = shard.rank_block(group, ids)
    _, alive = render_block_stats(mesh, CFG, own, 0, CFG.spp)
    return {"spans": got["spans"], "counters": got["counters"],
            "image_bytes": img.numel() * img.element_size(),
            "alive": alive.numpy(), "paths": own.shape[0] * CFG.spp}
