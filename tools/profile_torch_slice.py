#!/usr/bin/env python3
"""Where the time of one sample of the port's slice goes, on one GPU.

    python3 tools/profile_torch_slice.py [--samples N]

Builds the bunny stand-in of chip_smoke.py (69,451 triangles), renders
512x512 at 8 bounces one sample per launch, and prints: the wall time per
sample, each segment kernel's device time (CUDA events), and a
torch.profiler table of device time by kernel name with the device's busy
share of the window. Needs CUDA.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.render import render_block, tile_pixel_ids

    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4)
    args = ap.parse_args()

    dev = torch.device("cuda", 0)
    scene = chip_smoke.bunny_stand_in(dev)
    cfg = RenderConfig(width=512, height=512, spp=32, max_bounces=8,
                       enable_dof=False, ray_batch=512 * 512)
    ids = torch.from_numpy(tile_pixel_ids(512, 512)).to(dev)
    tables = mega.prepare_tables(scene, cfg)      # once, as render_image

    render_block(scene, cfg, ids, 0, 1, tables)   # build + warm up
    torch.cuda.synchronize()
    t0 = time.time()
    render_block(scene, cfg, ids, 1, args.samples, tables)
    torch.cuda.synchronize()
    print(f"wall per sample: {(time.time() - t0) / args.samples * 1e3:.3f} ms")

    # each segment's kernel time at the main path's shapes
    segs = chip_smoke.capture_segments(scene, cfg, ids)
    for state, u, ls, tables, seg in segs:
        ms = chip_smoke.time_ms(
            lambda: mega.mega_segment_cuda(state, u, ls, tables, seg), 5)
        live = int((state[10] > 0.5).sum())
        print(f"segment b={seg.b_start} nf={seg.n_fused}: {live} live of "
              f"{state.shape[1]}, kernel {ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.time()
        render_block(scene, cfg, ids, 1, args.samples, tables)
        torch.cuda.synchronize()
        window = time.time() - t0
    # device-side rows only: operator rows repeat their kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled window {window * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (window * 1e3):.1f}%)")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
