"""``render``: progressive rendering of the configuration's whole image.

Each launch is one sample of every pixel in the tile order, as
``render.render_image_resumable`` advances a render, sample-major: the
pixels in blocks of the configuration's ``ray_batch`` paths, each block
``render.render_block_stats(scene, cfg, ids, s, 1, tables)`` with the
segment tables built once in set-up, and the launch synchronised once
after its last block. Samples s = 0, 1, 2, ... until ``--seconds`` have
passed. Every launch must take the segment route: exactly the segment
launches of ``mega.segment_plan`` for each block and no traversal launch
(else the run fails). Parameters of the traffic file:

- ``warmup_launches``: launches of samples outside the window's, in
  set-up;
- ``check_rows_per_launch``: paths of each launch kept for the
  comparison, drawn from the seed;
- ``trace_launches``: launches profiled in a ``--trace 1`` run (the first
  of the window). Their segment launches must all reach the roofline's
  recorder and, on the card, the trace under the kernel's name
  (``trace.SEGMENT_KERNEL``), or the run fails.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import raycount, roofline
from portbench.common import (
    MAX_LAUNCHES, WARM_SAMPLE, draw_pool, launch_counts, reference_setup,
    render_numbers, route_check)
from portbench.harness import Record
from portbench.trace import SEGMENT_KERNEL, Tracer


def trace_check(recorded: int, in_trace: int | None, want: int):
    """Fail the run unless every segment launch of the traced launches
    (``want``) reached the roofline's recorder and, where a device trace
    was read (``in_trace`` not None), the trace under the kernel's name:
    a renamed kernel or a call past ``mega.mega_segment`` would otherwise
    move the segment's time into the glue's, unseen."""
    if recorded != want:
        raise SystemExit(f"trace check: {recorded} segment launches "
                         f"recorded through mega.mega_segment, want {want}")
    if in_trace is not None and in_trace != want:
        raise SystemExit(f"trace check: {in_trace} device operations named "
                         f"{SEGMENT_KERNEL!r} in the trace, want {want}")


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
                self.scene, self.cfg, ids, s, 1, self.tables)
            outs.append(out)
            alive = al if alive is None else alive + al
        self.ctx.sync()
        if self.on_card:
            route_check(c0, self.seg_per_launch,
                        f"the launch of sample {s}")
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), alive

    def measure(self) -> Record:
        import torch
        from offline_raytracer_tpu_torch import render
        from offline_raytracer_tpu_torch.config import RenderConfig
        from offline_raytracer_tpu_torch.ops import mega
        from offline_raytracer_tpu_torch.scene.build import SceneBuilder

        from portbench.inputs import recipe

        ctx = self.ctx
        dev = torch.device(ctx.device)
        self.render = render
        self.on_card = dev.type == "cuda"
        self.cfg = cfg = RenderConfig(**ctx.render, seed=ctx.seed32)
        with ctx.span("scene_build_s"):
            b = recipe.apply(SceneBuilder(), ctx.made, ctx.camera)
            self.scene = b.build(cfg.width, cfg.height, device=dev)
            if not mega.mega_ok(self.scene, cfg):
                raise SystemExit("the scene does not fit the segment kernel")
            with torch.no_grad():
                self.tables = mega.prepare_tables(self.scene, cfg)
            ctx.sync()
        self.ids = torch.from_numpy(
            recipe.tile_pixel_ids(cfg.width, cfg.height)).to(dev)
        P = self.ids.shape[0]
        # render_image's block: at most ray_batch paths per call
        self.blocks = list(self.ids.split(min(P, max(1, cfg.ray_batch))))
        self.seg_per_launch = len(mega.segment_plan(cfg)[0]) * len(
            self.blocks)
        nee = bool(cfg.enable_nee and self.scene.n_lights > 0)
        K = int(self.tr["check_rows_per_launch"])
        self.pool = draw_pool(P, K, ctx.seed, dev)
        n_warm = int(self.tr["warmup_launches"])
        n_trace = int(self.tr["trace_launches"]) if ctx.trace else 0
        tracer = reading = None
        recorded = []
        if n_trace:
            tracer = Tracer(n_warm, n_trace)
            tracer.start()
            original = mega.mega_segment
        with torch.no_grad():
            for w in range(n_warm):
                self._launch(WARM_SAMPLE + w)
                if tracer is not None:
                    tracer.step()
            if tracer is not None:

                def recording(state, u, ls, tables, seg):
                    st, rad = original(state, u, ls, tables, seg)
                    recorded.append((state, tables, seg, rad))
                    return st, rad

                mega.mega_segment = recording

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
                        mega.mega_segment = original
                        reading = tracer.stop(t1 - t_first, n_trace)
                else:
                    kept.append(out[self.pool[s]])
                s += 1
                if t1 >= deadline or s == MAX_LAUNCHES:
                    break
            window_s = t1 - t_first
            if tracer is not None and reading is None:
                mega.mega_segment = original
                reading = tracer.stop(t1 - t_first, s)
            if reading is not None:
                trace_check(len(recorded),
                            reading.count(SEGMENT_KERNEL) if self.on_card
                            else None,
                            self.seg_per_launch * reading.launches)
            kept = [held[k][self.pool[k]] for k in sorted(held)] + kept

            alive_np = torch.stack(alive).double().cpu().numpy()
            rays = sum(raycount.launch_rays(P, a, nee) for a in alive_np)
            bound_ms = sum(roofline.segment_bound(*r)[0] for r in recorded)
        ms = np.asarray(launch_s) * 1e3
        h = len(ms) // 2
        print(f"launch ms: median {np.median(ms):.3f}, p95 "
              f"{np.percentile(ms, 95):.3f}, max {ms.max():.3f}; halves' "
              f"medians {np.median(ms[:max(h, 1)]):.3f} "
              f"{np.median(ms[h:]):.3f}", file=sys.stderr)
        self.n, self.K = s, K
        self.kept = torch.cat(kept).cpu()
        self.alive_share = alive_np.sum(0) / (s * P)
        return Record(
            setup_s=setup_s, window_s=window_s, attempted=s,
            spans=dict(ctx.spans), trace=reading,
            values={"rays": rays, "launch_s": launch_s,
                    "segment_bound_ms": bound_ms if recorded else None})

    def free(self):
        """Drop the program's state before the reference runs."""
        import torch

        del self.scene, self.tables, self.blocks
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        import torch

        rows = self.pool[:self.n]
        pix = self.ids[rows].reshape(-1)
        smp = torch.arange(self.n, device=pix.device).repeat_interleave(
            self.K)
        return render_numbers(self.ctx, pix, smp, self.kept,
                              self.alive_share)


def control(ctx, launches: int, precision: str, fault=None) -> dict:
    """The comparison's numbers with the reference at ``precision`` in the
    program's place, over the check rows a run of ``ctx.seed`` draws for
    ``launches`` launches."""
    import torch

    from portbench.inputs import recipe
    from portbench.reference.paths import trace

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
    numbers = render_numbers(ctx, pix, smp, rad,
                             alive.float().mean(1).cpu().numpy())
    return {"paths": int(pix.shape[0]), **numbers}
