"""What the loops of ``portbench/loops/`` share: the route check, the rows
kept for the comparison, the reference's set-up and the render
comparison."""

from __future__ import annotations

import sys

import numpy as np

from portbench import check

# samples of the warm-up launches: far from the window's 0, 1, 2, ...
WARM_SAMPLE = 1 << 30
# samples of the target the reference renders for the grad loop
TARGET_SAMPLE = 1 << 29
# most launches a window can make (a pool of check rows is drawn for each)
MAX_LAUNCHES = 1 << 13


def launch_counts():
    """Launches of the (segment, cull, packet) kernels so far: the port's
    ``KERNEL_LAUNCHES`` counters."""
    from offline_raytracer_tpu_torch.ops import (
        mega, traverse_cull, traverse_packet)

    return (mega.KERNEL_LAUNCHES, traverse_cull.KERNEL_LAUNCHES,
            traverse_packet.KERNEL_LAUNCHES)


def route_check(c0, n_seg: int, what: str):
    """Fail the run unless the launches since counts ``c0`` were exactly
    ``n_seg`` segment launches and no traversal launch."""
    got = tuple(b - a for a, b in zip(c0, launch_counts()))
    if got != (n_seg, 0, 0):
        raise SystemExit(f"route check: {what} made (segment, cull, packet) "
                         f"launches {got}, want ({n_seg}, 0, 0)")


def draw_pool(P: int, K: int, seed: int, dev):
    """(MAX_LAUNCHES, K) rows of a launch's P pixels to compare, from the
    seed: launch s keeps rows pool[s]."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return torch.randint(P, (MAX_LAUNCHES, K), generator=gen, device=dev)


def reference_setup(ctx):
    """(the reference's scene, its config) from the recipe and the seed."""
    from portbench.inputs import recipe
    from portbench.reference.paths import RefConfig
    from portbench.reference.scene import SceneArrays

    fields = {k: v for k, v in ctx.render.items()
              if k in RefConfig.__dataclass_fields__}
    cfg = RefConfig(**fields, seed=ctx.seed32)
    sc = recipe.apply(SceneArrays(), ctx.made, ctx.camera).build(
        cfg.width, cfg.height, ctx.device)
    return sc, cfg


def render_numbers(ctx, pix, smp, prog_rad, prog_alive_share) -> dict:
    """The render comparison's numbers: ``prog_rad`` (N, 3), the radiance
    of paths (pix, smp), and ``prog_alive_share`` (B,) against the
    reference's."""
    from portbench.reference.paths import trace

    sc, cfg = reference_setup(ctx)
    ref_rad, ref_alive = trace(sc, cfg, pix, smp)
    share = ref_alive.float().mean(1).cpu().numpy()
    print("alive shares, program / reference: "
          + " ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(
              np.asarray(prog_alive_share), share)), file=sys.stderr)
    return {"path_mismatch_pct": check.path_mismatch_pct(prog_rad, ref_rad),
            "alive_z": check.alive_z(prog_alive_share, ref_alive)}
