"""``wavefront_bvh``: progressive rendering of a triangle mesh on the port's
wavefront route, its triangle queries through the BVH and NEE's shadow
queries among them.

The window is ``loops/wavefront.py``'s: each launch is one sample of every
pixel in the tile order, the pixels in blocks of the configuration's
``ray_batch`` paths, each block ``render.render_block_stats(scene, cfg,
ids, s, 1)`` (``render._paths_fn`` sends the scene to
``integrator.trace_paths`` with ``traverse.make_bvh_trace_fn`` and
``make_bvh_occlusion_fn``), and the launch synchronised once after its
last block. Samples s = 0, 1, 2, ... until ``--seconds`` have passed.

The scene is the recipe's calls, then the mesh of the configuration's
``spd_tetra`` entry (``inputs/spd_tetra.py``), which takes the recipe's
last material; then the camera and the configuration's ``sky``. The
program's ``SceneBuilder`` and the reference's ``WaveBvhScene`` get the
same calls.

The route check fails the run, on every launch, on a segment or packet
launch and, on the card, on a count of cull launches other than two a
bounce of every block (the closest-hit and the shadow query); and, read
with the program's recorder on over the warm-up launch and, in a
``--trace 1`` run, over the traced launches, on a count of the program's
``wave.hit``, ``traverse.closest`` or ``traverse.any`` spans other than
``max_bounces`` a block. A program that records no triangle query spans
fails it at its warm-up launch. The comparison traces the kept rows with
the plain reference of this route (``reference/wave_bvh.py``). Parameters
of the traffic file:

- ``warmup_launches``: launches of samples outside the window's, in
  set-up;
- ``check_rows_per_launch``: paths of each launch kept for the
  comparison, drawn from the seed;
- ``trace_launches``: launches profiled in a ``--trace 1`` run (the first
  of the window), with the program's recorder on and ``spans.SpanTracer``
  keeping its spans and counters for the ``.wave`` and ``.bvh`` readers.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import check, raycount
from portbench.common import (
    MAX_LAUNCHES, WARM_SAMPLE, draw_pool, launch_counts)
from portbench.harness import Record
from portbench.spans import SpanTracer as Tracer


def span_check(flushed: dict, want: dict, what: str):
    """Fail the run unless the recorder's flush holds ``want[name]`` spans
    of each name: a bounce's closest-hit query (``wave.hit``), its
    triangle query within it (``traverse.closest``) and, with NEE, its
    triangle shadow query (``traverse.any``), once a bounce of every
    block."""
    for name, n in want.items():
        got = sum(s["name"] == name for s in flushed["spans"])
        if got != n:
            raise SystemExit(f"route check: {what} made {got} {name} spans, "
                             f"want {n}")


def route_check(c0, n_cull: int, what: str):
    """Fail the run unless the launches since counts ``c0`` were no
    segment launch, ``n_cull`` cull launches and no packet launch."""
    got = tuple(b - a for a, b in zip(c0, launch_counts()))
    if got != (0, n_cull, 0):
        raise SystemExit(f"route check: {what} made (segment, cull, packet) "
                         f"launches {got}, want (0, {n_cull}, 0)")


def scene_calls(ctx) -> list:
    """The recipe's calls and then the configuration's mesh, made once per
    run."""
    made = getattr(ctx, "bvh_made", None)
    if made is None:
        from portbench.inputs.spd_tetra import mesh_call

        with ctx.span("inputs_s"):
            made = ctx.made + [mesh_call(ctx.cell.config["spd_tetra"])]
        ctx.bvh_made = made
    return made


def reference_setup(ctx):
    """(the reference's scene, its config) from the scene's calls, the
    configuration's sky and the seed."""
    from portbench.inputs import recipe
    from portbench.reference.paths import RefConfig
    from portbench.reference.wave_bvh import WaveBvhScene

    fields = {k: v for k, v in ctx.render.items()
              if k in RefConfig.__dataclass_fields__}
    cfg = RefConfig(**fields, seed=ctx.seed32)
    b = recipe.apply(WaveBvhScene(), scene_calls(ctx), ctx.camera)
    b.set_sky(**ctx.cell.config["sky"])
    return b.build(cfg.width, cfg.height, ctx.device), cfg


def bvh_numbers(ctx, pix, smp, prog_rad, prog_alive_share,
                precision="float32") -> dict:
    """The comparison's numbers: ``prog_rad`` (N, 3), the radiance of
    paths (pix, smp), and ``prog_alive_share`` (B,) against the
    reference's at ``precision``."""
    from portbench.reference.wave_bvh import trace

    sc, cfg = reference_setup(ctx)
    ref_rad, ref_alive = trace(sc, cfg, pix, smp, precision)
    share = ref_alive.float().mean(1).cpu().numpy()
    print("alive shares, program / reference: "
          + " ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(
              np.asarray(prog_alive_share), share)), file=sys.stderr)
    return {"path_mismatch_pct": check.path_mismatch_pct(prog_rad, ref_rad),
            "alive_z": check.alive_z(prog_alive_share, ref_alive)}


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.cell.traffic

    def _launch(self, s):
        """One synchronised launch of sample ``s`` over every block, with
        its route check: (radiance (P, 3) in the tile order, alive counts
        (B,) summed over the blocks)."""
        import torch

        c0 = launch_counts()
        outs, alive = [], None
        for ids in self.blocks:
            out, al = self.render.render_block_stats(
                self.scene, self.cfg, ids, s, 1)
            outs.append(out)
            alive = al if alive is None else alive + al
        self.ctx.sync()
        route_check(c0, self.cull_per_launch, f"the launch of sample {s}")
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), alive

    def measure(self) -> Record:
        import torch
        from offline_raytracer_tpu_torch import render
        from offline_raytracer_tpu_torch.config import RenderConfig
        from offline_raytracer_tpu_torch.ops import mega
        from offline_raytracer_tpu_torch.scene.build import SceneBuilder
        from offline_raytracer_tpu_torch.utils import profiling

        from portbench.inputs import recipe

        ctx = self.ctx
        dev = torch.device(ctx.device)
        self.render = render
        self.cfg = cfg = RenderConfig(**ctx.render, seed=ctx.seed32)
        made = scene_calls(ctx)
        with ctx.span("scene_build_s"):
            b = recipe.apply(SceneBuilder(), made, ctx.camera)
            b.set_sky(**ctx.cell.config["sky"])
            self.scene = b.build(cfg.width, cfg.height, device=dev)
            if mega.mega_ok(self.scene, cfg):
                raise SystemExit("the scene fits the segment kernel: this "
                                 "loop measures the wavefront route")
            ctx.sync()
        self.ids = torch.from_numpy(
            recipe.tile_pixel_ids(cfg.width, cfg.height)).to(dev)
        P = self.ids.shape[0]
        # render_image's block: at most ray_batch paths per call
        self.blocks = list(self.ids.split(min(P, max(1, cfg.ray_batch))))
        per_launch = cfg.max_bounces * len(self.blocks)
        nee = bool(cfg.enable_nee and self.scene.n_lights > 0)
        spans = {"wave.hit": per_launch, "traverse.closest": per_launch,
                 "traverse.any": per_launch if nee else 0}
        # the cull kernel answers the card's queries; the CPU's take the
        # plain sweep and launch nothing
        self.cull_per_launch = ((1 + nee) * per_launch
                                if dev.type == "cuda" else 0)
        K = int(self.tr["check_rows_per_launch"])
        self.pool = draw_pool(P, K, ctx.seed, dev)
        n_warm = int(self.tr["warmup_launches"])
        n_trace = int(self.tr["trace_launches"]) if ctx.trace else 0
        tracer = reading = None
        profiling.flush()
        if n_trace:
            tracer = Tracer(n_warm, n_trace)
            tracer.start()
        with torch.no_grad():
            for w in range(n_warm):
                with profiling.recording():
                    self._launch(WARM_SAMPLE + w)
                span_check(profiling.flush(), spans,
                           f"the warm-up launch {w}")
                if tracer is not None:
                    tracer.step()
            if tracer is not None:
                profiling.enable()

            launch_s, alive, kept, held = [], [], [], {}
            t_first = time.perf_counter()
            setup_s = t_first - ctx.t_start
            deadline = t_first + ctx.seconds
            s = 0
            while True:
                t0 = time.perf_counter()
                out, al = self._launch(s)
                t1 = time.perf_counter()
                launch_s.append(t1 - t0)
                alive.append(al)
                if s < n_trace:
                    held[s] = out
                    tracer.step()
                    if s == n_trace - 1:
                        reading = tracer.stop(t1 - t_first, n_trace)
                        profiling.disable()
                else:
                    kept.append(out[self.pool[s]])
                s += 1
                if t1 >= deadline or s == MAX_LAUNCHES:
                    break
            window_s = t1 - t_first
            if tracer is not None and reading is None:
                reading = tracer.stop(t1 - t_first, s)
                profiling.disable()
            if reading is not None:
                span_check(reading.program, {
                    k: n * reading.launches for k, n in spans.items()},
                    "the traced launches")
            kept = [held[k][self.pool[k]] for k in sorted(held)] + kept

            alive_np = torch.stack(alive).double().cpu().numpy()
            rays = sum(raycount.launch_rays(P, a, nee) for a in alive_np)
        ms = np.asarray(launch_s) * 1e3
        h = len(ms) // 2
        print(f"launch ms: median {np.median(ms):.3f}, p95 "
              f"{np.percentile(ms, 95):.3f}, max {ms.max():.3f}; halves' "
              f"medians {np.median(ms[:max(h, 1)]):.3f} "
              f"{np.median(ms[h:]):.3f}", file=sys.stderr)
        self.n, self.K = s, K
        self.kept = torch.cat(kept).cpu()
        self.alive_share = alive_np.sum(0) / (s * P)
        bvh = self.scene.tri_bvh
        return Record(
            setup_s=setup_s, window_s=window_s, attempted=s,
            spans=dict(ctx.spans), trace=reading,
            values={"rays": rays, "launch_s": launch_s,
                    "spheres": int(self.scene.spheres.radius.shape[0]),
                    "tri_tables": _table_sizes(bvh)})

    def free(self):
        """Drop the program's state before the reference runs."""
        import torch

        del self.scene, self.blocks
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        import torch

        rows = self.pool[:self.n]
        pix = self.ids[rows].reshape(-1)
        smp = torch.arange(self.n, device=pix.device).repeat_interleave(
            self.K)
        return bvh_numbers(self.ctx, pix, smp, self.kept, self.alive_share)


def _table_sizes(bvh) -> dict:
    """The float32 elements of the tables a cull query reads once, in the
    layout ``traverse.tri_tables`` gives the kernel (the leaf boxes, the
    leaf-major coefficient rows, the sub-boxes padded to 8 numbers), and
    the tree's leaves, for ``roofline_tri``."""
    sub = bvh.sub_bounds
    return {"leaf_bounds": int(bvh.leaf_bounds.numel()),
            "tri_lm": int(bvh.planes.numel()),
            "sub": int(sub.shape[0] * sub.shape[1] * 8),
            "n_leaves": int(bvh.n_leaves)}


def control(ctx, launches: int, precision: str, fault=None) -> dict:
    """The comparison's numbers with the reference at ``precision`` in the
    program's place, over the check rows a run of ``ctx.seed`` draws for
    ``launches`` launches."""
    import torch

    from portbench.inputs import recipe
    from portbench.reference.wave_bvh import trace

    if fault is not None:
        raise SystemExit("a render cell's control plants no fault")
    sc, cfg = reference_setup(ctx)
    ids = torch.from_numpy(recipe.tile_pixel_ids(cfg.width, cfg.height)).to(
        ctx.device)
    K = int(ctx.cell.traffic["check_rows_per_launch"])
    pool = draw_pool(ids.shape[0], K, ctx.seed, ids.device)
    pix = ids[pool[:launches]].reshape(-1)
    smp = torch.arange(launches, device=ids.device).repeat_interleave(K)
    rad, alive = trace(sc, cfg, pix, smp, precision)
    numbers = bvh_numbers(ctx, pix, smp, rad,
                          alive.float().mean(1).cpu().numpy())
    return {"paths": int(pix.shape[0]), **numbers}
