"""Command-line renderer (counterpart of ``offline_raytracer_tpu/cli.py``).

Every knob of a render is a flag. It renders on the card unless
``--device cpu`` is given. Usage:

    python -m offline_raytracer_tpu_torch.cli --scene data/testscene.scn \
        --spp 256 --out out/render.hdr
    python -m offline_raytracer_tpu_torch.cli --preset bunny --spp 64 --meter

The image size is the .scn's ``screen`` or the preset's own unless
``--width``/``--height`` say otherwise.

``--sharded`` splits the pixels over one rank per visible card (one rank on
the CPU), each a process of its own (``parallel/shard.run_ranks``);
``--multihost`` makes this process one rank of a group given by
``--coordinator``/``--num-processes``/``--process-id`` or by torchrun's
environment, and implies ``--sharded``:

    torchrun --nproc-per-node 4 -m offline_raytracer_tpu_torch.cli \
        --multihost --scene data/testscene.scn --spp 256

Rank 0 alone writes the files and prints the JSON line. A sharded render
takes no ``--checkpoint`` and no ``--meter`` (the JAX CLI drops them
silently; here they are refused).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="offline_raytracer_tpu_torch",
        description="differentiable path tracer, PyTorch + CUDA")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help=".scn scene file")
    src.add_argument("--preset", choices=["analytic", "letter", "bunny",
                                          "dwarf", "testscene",
                                          "spd_tetra"])
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-bounces", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rr", type=float, default=0.8,
                   help="Russian-roulette survival prob")
    p.add_argument("--no-nee", action="store_true",
                   help="BSDF sampling only (reference mode)")
    p.add_argument("--no-dof", action="store_true")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--no-pallas", action="store_true",
                   help="plain PyTorch triangle queries instead of the "
                        "kernels (the JAX flag's name)")
    p.add_argument("--reference-mode", action="store_true",
                   help="match reference estimator: no NEE, no pixel jitter")
    p.add_argument("--ray-batch", type=int, default=1 << 17)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda by default; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--sharded", action="store_true",
                   help="split the pixels over one rank per visible card")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group (from the three flags below "
                        "or torchrun's environment) as one rank; implies "
                        "--sharded")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (with --multihost)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--out", default="out/render.hdr")
    p.add_argument("--png", default=None, help="also write a tonemapped png")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--progress", action="store_true")
    p.add_argument("--config", default=None,
                   help="YAML file of RenderConfig fields (flags win)")
    p.add_argument("--checkpoint", default=None,
                   help="durable accumulation checkpoint (.npz); resumes if "
                        "present")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="spp between checkpoint writes")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) "
                   "and the program's spans and counters (spans.jsonl) "
                   "here")
    p.add_argument("--meter", action="store_true",
                   help="emit a rays/s render-meter JSON line (stderr)")
    return p


def load_yaml_config(path: str) -> dict:
    """RenderConfig fields from a YAML file; unknown keys are refused."""
    import dataclasses

    import yaml

    from offline_raytracer_tpu_torch.config import RenderConfig

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise SystemExit(
            f"unknown RenderConfig keys in {path}: {sorted(unknown)}")
    return raw


def config_from_args(args, width: int, height: int):
    """The RenderConfig of parsed flags at (width, height): the --config
    file's fields, then the flags over them."""
    from offline_raytracer_tpu_torch.config import RenderConfig

    yaml_kw = load_yaml_config(args.config) if args.config else {}
    return RenderConfig(**yaml_kw).replace(
        width=width, height=height, spp=args.spp, seed=args.seed,
        max_bounces=args.max_bounces, russian_roulette=args.rr,
        enable_nee=not (args.no_nee or args.reference_mode),
        enable_mis=not (args.no_nee or args.reference_mode),
        pixel_jitter=not args.reference_mode,
        reference_rr_quirk=args.reference_mode,
        enable_dof=not args.no_dof,
        use_bvh=not args.no_bvh,
        use_pallas=not args.no_pallas,
        ray_batch=args.ray_batch,
    )


def main(argv=None) -> int:
    """Render as the flags say; 0 on success (any failure raises)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    args.sharded = args.sharded or args.multihost
    if args.sharded and (args.checkpoint or args.meter):
        parser.error("--checkpoint and --meter do not combine with "
                     "--sharded or --multihost")
    if args.multihost:
        import torch.distributed as dist

        from offline_raytracer_tpu_torch.parallel.shard import (
            init_process_group, make_group)

        rank = init_process_group(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device)
        print(f"multihost: rank {rank}", file=sys.stderr)
        try:
            render_main(make_group(args.device), args)
        finally:
            dist.destroy_process_group()
    elif args.sharded:
        import torch

        from offline_raytracer_tpu_torch import cli
        from offline_raytracer_tpu_torch.parallel.shard import run_ranks
        from offline_raytracer_tpu_torch.scene.types import scene_device

        dev = scene_device(args.device)
        n = (torch.cuda.device_count()
             if dev.type == "cuda" and dev.index is None else 1)
        # by the package's name, which a spawned rank imports also when
        # this module runs as __main__; a render takes as long as it takes
        run_ranks(cli.render_main, n, args, device=args.device,
                  deadline_s=float("inf"))
    else:
        render_main(None, args)
    return 0


def render_main(group, args) -> None:
    """Load, render and write as ``args`` say: in this process alone
    (``group`` None), or as one rank of a sharded render, where rank 0
    alone writes the files and prints the JSON line."""
    from offline_raytracer_tpu_torch.parallel.shard import (
        render_image_sharded)
    from offline_raytracer_tpu_torch.render import (
        render_image, render_image_resumable)
    from offline_raytracer_tpu_torch.scene.types import scene_device
    from offline_raytracer_tpu_torch.utils import hdr
    from offline_raytracer_tpu_torch.utils.profiling import (
        RenderMeter, device_trace)

    device = scene_device(args.device) if group is None else group.device
    t0 = time.time()
    if args.scene:
        from offline_raytracer_tpu_torch.scene.scn import load_scene
        scene, (w, h) = load_scene(args.scene, args.width, args.height,
                                   device=device)
    else:
        from offline_raytracer_tpu_torch.models.scenes import preset
        scene, (w, h) = preset(args.preset, args.width, args.height,
                               device=device)
    print(f"scene loaded in {time.time() - t0:.1f}s "
          f"({int(scene.triangles.mat.shape[0])} tris, "
          f"{int(scene.spheres.radius.shape[0])} spheres, "
          f"{scene.n_lights} NEE lights) on {device}", file=sys.stderr)

    cfg = config_from_args(args, w, h)
    meter = RenderMeter() if args.meter else None
    trace_dir = args.trace_dir
    if trace_dir and group is not None and group.size > 1:
        trace_dir = os.path.join(trace_dir, f"rank{group.rank}")

    t0 = time.time()
    with device_trace(trace_dir):
        if group is not None:
            img = render_image_sharded(scene, cfg, group)
        elif args.checkpoint:
            img = render_image_resumable(
                scene, cfg, args.checkpoint,
                checkpoint_every_spp=args.checkpoint_every,
                progress=args.progress, meter=meter)
        else:
            img = render_image(scene, cfg, progress=args.progress,
                               meter=meter)
    dt = time.time() - t0
    if meter is not None:
        meter.emit()
    n_paths = w * h * args.spp
    print(f"rendered {w}x{h} @ {args.spp}spp in {dt:.1f}s "
          f"({n_paths / dt / 1e6:.2f} Mpaths/s)", file=sys.stderr)
    if group is not None and group.rank != 0:
        return

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    hdr.write_hdr(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.png:
        os.makedirs(os.path.dirname(args.png) or ".", exist_ok=True)
        hdr.write_png(args.png, hdr.tonemap(img, exposure=args.exposure))
        print(f"wrote {args.png}", file=sys.stderr)
    print(json.dumps({"seconds": dt, "mpaths_per_s": n_paths / dt / 1e6,
                      "width": w, "height": h, "spp": args.spp}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
