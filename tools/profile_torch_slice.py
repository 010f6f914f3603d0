#!/usr/bin/env python3
"""Where the time of one sample of the port's slice goes, on one GPU.

    python3 tools/profile_torch_slice.py [--samples N] [--traversal ROUTE]
    python3 tools/profile_torch_slice.py [--traversal ROUTE] --sweep
    python3 tools/profile_torch_slice.py --grad [--samples N]

Builds the bunny stand-in of chip_smoke.py (69,451 triangles) and renders
512x512 at 8 bounces, one sample per launch, through ``--traversal``:

- ``mega`` (default): the segment route. Prints the wall time per sample,
  each segment kernel's device time (CUDA events) at the main path's
  shapes, at the lanes per ray ``mega.group_size`` picks and at one lane
  per ray, and a torch.profiler table of device time by kernel name with
  the device's busy share of the window.
- ``--sweep``: each segment of one sample at every group size of
  ``mega.GROUPS``, each held bit for bit against one lane per ray, after
  the kernel's registers, stack frame and spills.
- ``cull`` or ``packet``: the wavefront route. Prints the wall time per
  sample; then, for one sample with a synchronise around each triangle
  query (so the parts add up, at the cost of the overlap between host and
  device), the time of the queries (one kernel launch each), the rest
  being the shading glue, and the peak device memory; then each of the
  sample's 16 queries through the kernel alone (CUDA events) and their
  sum; then the same profiler table. With
  ``--sweep``: each query at every group size of ``traverse.GROUPS``,
  after the kernel's registers, stack frame and spills.
- ``--grad``: the gradient step of ``chip_smoke.py`` phase 8 (the first
  65,536 pixels of the tile order, 1 spp, replay-value, gradients with
  respect to the albedo and the mesh's v0). Prints the wall time per step;
  the split of a step into the segment launches with records, the replay's
  forward and the backward (CUDA events between the parts, averaged over
  ``--samples`` steps); the peak device memory of a step; each of the
  step's segment launches alone (CUDA events) at the lanes per ray
  ``mega.group_size`` picks and at one lane per ray; then the profiler
  table over ``--samples`` steps.

Needs CUDA.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def profile_table(render, window_label):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.time()
        render()
        torch.cuda.synchronize()
        window = time.time() - t0
    # device-side rows only: operator rows repeat their kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled window ({window_label}) {window * 1e3:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / (window * 1e3):.1f}%)")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


class SyncTimer:
    """Wraps a module function: synchronises before and after each call
    and sums the wall time between."""

    def __init__(self, module, name):
        import torch

        self.ms = 0.0
        self.calls = 0
        fn = getattr(module, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms += (time.time() - t0) * 1e3
            self.calls += 1
            return out

        self.restore = lambda: setattr(module, name, fn)
        setattr(module, name, timed)


def query_times(scene, cfg, ids, groups=None):
    """Each triangle query of one full-size sample through the route's
    kernel (CUDA events, at the lanes per ray its wrapper picks, or at
    each of ``groups``): [(bounce, kind, live rays, {G or "rule": ms})]."""
    import chip_smoke
    from offline_raytracer_tpu_torch.ops import traverse_cull, traverse_packet

    mod = traverse_cull if cfg.traversal == "cull" else traverse_packet
    fn = getattr(mod, f"bvh_hit_ts_{cfg.traversal}_cuda")
    rows = []
    for k, (tables, ro, rd, tf, any_hit) in enumerate(
            chip_smoke.capture_queries(scene, cfg, ids)):
        live = int((ro.abs().amax(1) < 1e7).sum() if tf is None
                   else ((tf > cfg.t_min) & (ro.abs().amax(1) < 1e7)).sum())
        ms = {}
        for g in groups or ("rule",):
            kw = {} if g == "rule" else {"group": g}
            ms[g] = chip_smoke.time_ms(lambda: fn(
                tables, ro, rd, cfg.t_min, tf, any_hit, **kw), 5)
        rows.append((k // 2, "shadow" if any_hit else "closest", live, ms))
    return rows


def wavefront(scene, cfg, ids, samples, sweep):
    import torch
    from offline_raytracer_tpu_torch.ops import traverse_cull, traverse_packet
    from offline_raytracer_tpu_torch.render import render_block

    if sweep:
        import chip_smoke
        from offline_raytracer_tpu_torch.ops import _kernels, traverse

        info = _kernels.build(f"traverse_{cfg.traversal}")
        print(" | ".join(chip_smoke.ptxas_summary(info["log"])))
        total = dict.fromkeys(traverse.GROUPS, 0.0)
        for b, kind, live, ms in query_times(scene, cfg, ids,
                                             traverse.GROUPS):
            for g, t in ms.items():
                total[g] += t
            print(f"b={b} {kind}: {live} live, kernel ms by lanes per ray: "
                  + ", ".join(f"G={g} {t:.3f}" for g, t in ms.items()))
        print("per sample: " + ", ".join(f"G={g} {t:.3f}"
                                         for g, t in total.items()))
        return

    render_block(scene, cfg, ids, 0, 1)           # build + warm up
    torch.cuda.synchronize()
    t0 = time.time()
    render_block(scene, cfg, ids, 1, samples)
    torch.cuda.synchronize()
    print(f"wall per sample ({cfg.traversal}): "
          f"{(time.time() - t0) / samples * 1e3:.3f} ms")

    # one sample with every triangle query synchronised and timed
    mod = traverse_cull if cfg.traversal == "cull" else traverse_packet
    timer = SyncTimer(mod, f"bvh_hit_ts_{cfg.traversal}_cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    render_block(scene, cfg, ids, 1, 1)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    timer.restore()
    print(f"one synchronised sample: {wall:.3f} ms; triangle queries "
          f"{timer.ms:.3f} ms in {timer.calls} calls; shading glue and "
          f"sorts {wall - timer.ms:.3f} ms; peak device memory {peak:.1f} "
          f"MiB")

    # each query's kernel time at the route's shapes
    total = 0.0
    for b, kind, live, ms in query_times(scene, cfg, ids):
        total += ms["rule"]
        print(f"  query b={b} {kind}: {live} live, {ms['rule']:.4f} ms")
    print(f"  the sample's queries through the kernel: {total:.4f} ms")
    profile_table(lambda: render_block(scene, cfg, ids, 1, samples),
                  f"{samples} samples")


def grad_breakdown(scene, cfg, ids, steps):
    import dataclasses

    import chip_smoke
    import torch
    from offline_raytracer_tpu_torch.integrator import trace_paths
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.ops.intersect import prefetch_hit_params
    from offline_raytracer_tpu_torch.utils import rng

    gcfg = cfg.replace(spp=1, grad_mode="replay-value")
    gids = ids[:chip_smoke.GRAD_PIXELS]
    chip_smoke.grad_step(scene, gcfg, gids, "replay-value")    # warm up
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        chip_smoke.grad_step(scene, gcfg, gids, "replay-value")
    torch.cuda.synchronize()
    print(f"wall per gradient step: {(time.time() - t0) / steps * 1e3:.3f} "
          f"ms ({steps} steps, one sync)")

    # the step's parts, as render_block runs them for sample 0
    kd = scene.materials.diffuse.clone().requires_grad_(True)
    v0 = scene.triangles.v0.clone().requires_grad_(True)
    sc = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, diffuse=kd),
        triangles=dataclasses.replace(scene.triangles, v0=v0))
    keys = rng.pixel_sample_keys(rng.render_key(gcfg.seed, gids.device),
                                 gids, torch.zeros_like(gids))
    ro, rd = generate_rays(scene.camera, gcfg, gids, keys)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = [0.0, 0.0, 0.0]
    for _ in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev[0].record()
        with torch.no_grad():
            tables = mega.prepare_tables(sc, gcfg)
            _, hit_ids, vis, _ = mega.render_paths_mega(
                sc, gcfg, ro, rd, keys, collect_records=True, tables=tables)
        ev[1].record()
        rad = trace_paths(sc, gcfg, None, ro, rd, keys, replay=(hit_ids, vis))
        ev[2].record()
        torch.autograd.grad(rad.mean(), (kd, v0))
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / steps
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"gradient step split (CUDA events, {steps} steps): segment "
          f"launches with records {parts[0]:.3f} ms, replay forward "
          f"{parts[1]:.3f} ms, backward {parts[2]:.3f} ms; peak device "
          f"memory {peak:.1f} MiB")

    # the step's segment launches alone, at its shapes
    total = {"rule": 0.0, "G=1": 0.0}
    for s in chip_smoke.capture_segments(scene, gcfg, gids):
        g = mega.group_size(s[4], s[0].shape[1])
        ms = chip_smoke.group_times(s, (1, g))
        total["rule"] += ms[g]
        total["G=1"] += ms[1]
        print(f"  step segment b={s[4].b_start} nf={s[4].n_fused}: "
              f"{int((s[0][10] > 0.5).sum())} live of {s[0].shape[1]}, "
              f"kernel {ms[g]:.3f} ms at G={g} ({ms[1]:.3f} ms at G=1)")
    print(f"  the step's segment kernels: {total['rule']:.3f} ms at the "
          f"rule's G, {total['G=1']:.3f} ms at G=1")

    # the backward of each differentiated gather alone, at the step's
    # index shapes (all bounces' recorded winners at once)
    base = (scene.spheres.radius.shape[0] + scene.boxes.mat.shape[0]
            + scene.cylinders.radius.shape[0])
    slot = torch.clamp(hit_ids - base, 0,
                       scene.tri_bvh.tri_index.shape[0] - 1).long()
    gathers = {
        "albedo[material]": (scene.materials.diffuse, prefetch_hit_params(
            scene, hit_ids)["mat"].long()),
        "v0[triangle]": (scene.triangles.v0, torch.clamp(
            scene.tri_bvh.tri_index[slot], min=0).long())}
    for name, (table, idx) in gathers.items():
        x = table.detach().clone().requires_grad_(True)
        out = x[idx]
        g = torch.ones_like(out)
        ms = chip_smoke.time_ms(
            lambda: torch.autograd.grad(out, x, g, retain_graph=True), 5)
        print(f"  backward of {name} ({tuple(idx.shape)} indices into "
              f"{x.shape[0]} rows, {int(torch.unique(idx).numel())} "
              f"distinct): {ms:.3f} ms")

    def run():
        for _ in range(steps):
            chip_smoke.grad_step(scene, gcfg, gids, "replay-value")
    profile_table(run, f"{steps} gradient steps")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.render import render_block, tile_pixel_ids

    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--traversal", default="mega",
                    choices=("mega", "cull", "packet"))
    ap.add_argument("--grad", action="store_true",
                    help="profile the gradient step instead")
    ap.add_argument("--sweep", action="store_true",
                    help="time each segment (or with --traversal cull or "
                    "packet, each triangle query) at every group size")
    args = ap.parse_args()

    dev = torch.device("cuda", 0)
    scene = chip_smoke.bunny_stand_in(dev)
    cfg = RenderConfig(width=512, height=512, spp=32, max_bounces=8,
                       enable_dof=False, ray_batch=512 * 512,
                       traversal=args.traversal)
    ids = torch.from_numpy(tile_pixel_ids(512, 512)).to(dev)
    if args.traversal != "mega" and not args.grad:
        wavefront(scene, cfg, ids, args.samples, args.sweep)
        return 0
    if args.sweep:
        from offline_raytracer_tpu_torch.ops import _kernels

        info = _kernels.build("mega")
        print(" | ".join(chip_smoke.ptxas_summary(info["log"])))
        segs = chip_smoke.capture_segments(scene, cfg, ids)
        for s in segs:
            live = int((s[0][10] > 0.5).sum())
            ms = chip_smoke.group_times(s, mega.GROUPS)
            print(f"segment b={s[4].b_start} nf={s[4].n_fused}: {live} live "
                  f"of {s[0].shape[1]}, kernel ms by lanes per ray: "
                  + ", ".join(f"G={g} {t:.3f}" for g, t in ms.items())
                  + " (outputs bitwise equal to G=1)")
        return 0
    if args.grad:
        grad_breakdown(scene, cfg, ids, args.samples)
        return 0

    tables = mega.prepare_tables(scene, cfg)      # once, as render_image
    render_block(scene, cfg, ids, 0, 1, tables)   # build + warm up
    torch.cuda.synchronize()
    t0 = time.time()
    render_block(scene, cfg, ids, 1, args.samples, tables)
    torch.cuda.synchronize()
    print(f"wall per sample: {(time.time() - t0) / args.samples * 1e3:.3f} ms")

    # each segment's kernel time at the main path's shapes
    segs = chip_smoke.capture_segments(scene, cfg, ids)
    for s in segs:
        g = mega.group_size(s[4], s[0].shape[1])
        ms = chip_smoke.group_times(s, (1, g))
        live = int((s[0][10] > 0.5).sum())
        print(f"segment b={s[4].b_start} nf={s[4].n_fused}: {live} live of "
              f"{s[0].shape[1]}, kernel {ms[g]:.3f} ms at G={g} "
              f"({ms[1]:.3f} ms at G=1)")

    profile_table(lambda: render_block(scene, cfg, ids, 1, args.samples,
                                       tables), f"{args.samples} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
