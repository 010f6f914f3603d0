#!/usr/bin/env python3
"""Scaling of the port's ``parallel/`` over the cards of one machine.

    python3 tools/parallel_scaling.py [--ranks 1 2 4] [--samples N] [--cli]

For each rank count (one NCCL rank per card; a count above the cards
present is skipped) it spawns the ranks with ``parallel/shard.run_ranks``.
Each builds ``chip_smoke.py``'s bunny stand-in (69,451 triangles) on its
card and measures:

- the sharded render: its block of the 512x512 image, ``--samples``
  samples, 8 bounces, DOF off, through ``render_block_stats`` (the segment
  route, tables built once) and the ``all_gather`` of the blocks, after one
  untimed sample; the wall from a barrier to the gather's end, synchronised,
  the slowest rank's; rays counted from each rank's alive counts as
  ``chip_smoke.py`` counts them, summed over the ranks in float64;
- the ring: the stand-in in as many Morton shards as ranks, one sample of
  the whole image through ``render_block_ring`` (``traversal="auto"``: the
  cull kernel), after one untimed sample; its wall, the slowest rank's,
  over a rank's ring steps (S closest-hit and S shadow steps per bounce)
  gives the seconds per rotation step; each rank's BVH bytes on its card.

Prints one JSON line per rank count, with the card's name and power limit.
With ``--cli``: writes ``chip_smoke.py`` phase 10's .scn (the stand-in as a
.ply, an .obj) and renders it with the command line at 64 spp, 8 bounces,
DOF off, in one process and then through ``torchrun --nproc-per-node N
--multihost`` for each rank count above 1, printing each JSON line and
whether the images are equal.

Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]


def measure_rank(group, samples):
    """One rank's sharded and ring measurements."""
    import torch
    import torch.distributed as dist
    from chip_smoke import BOUNCES, H, W, bunny_stand_in, table_bytes
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.parallel import ring, shard
    from offline_raytracer_tpu_torch.render import render_block_stats

    dev = group.device
    scene = bunny_stand_in(dev)
    cfg = RenderConfig(width=W, height=H, spp=samples, max_bounces=BOUNCES,
                       enable_dof=False)
    ids = torch.arange(W * H, dtype=torch.int32, device=dev)
    block = shard.rank_block(group, ids)
    tables = mega.prepare_tables(scene, cfg)

    def slowest(seconds):
        return float(shard.all_gather(group, torch.tensor(
            [seconds], dtype=torch.float64, device=dev)).max())

    render_block_stats(scene, cfg, block, 0, 1, tables)
    torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.time()
    out, alive = render_block_stats(scene, cfg, block, 1, samples, tables)
    shard.all_gather(group, out)
    torch.cuda.synchronize(dev)
    dt = slowest(time.time() - t0)
    a = alive.to(torch.float64)
    n_paths = block.shape[0] * samples
    rays = n_paths + a.sum() + n_paths + a[:-1].sum()     # NEE is on
    rays = float(shard.all_reduce_sum(group, rays.reshape(1)))

    shards = ring.prepare_ring_shards(scene, group)
    rcfg = cfg.replace(spp=1, traversal="auto")
    ring.render_block_ring(scene, rcfg, group, ids, 0, 1, shards)
    torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.time()
    ring.render_block_ring(scene, rcfg, group, ids, 1, 1, shards)
    torch.cuda.synchronize(dev)
    ring_s = slowest(time.time() - t0)
    steps = 2 * group.size * BOUNCES
    return {"ranks": group.size, "backend": group.backend,
            "sharded_samples": samples, "sharded_s": dt,
            "sharded_rays": rays, "sharded_mrays_per_s": rays / dt / 1e6,
            "ring_sample_s": ring_s, "ring_steps_per_rank": steps,
            "ring_s_per_step": ring_s / steps,
            "ring_bvh_bytes": table_bytes(shards)}


def cli_runs(ranks, card):
    """The command line on phase 10's .scn in one process and through
    torchrun at each rank count above 1."""
    import numpy as np
    from chip_smoke import BOUNCES, N_TRIS
    from offline_raytracer_tpu_torch.parallel.shard import free_port
    from offline_raytracer_tpu_torch.utils import hdr
    from torch_port_cases import procedural_mesh, write_scene_files

    env = dict(os.environ, PYTHONPATH=HERE)
    with tempfile.TemporaryDirectory() as tmp:
        scn = write_scene_files(tmp, *procedural_mesh(N_TRIS))
        flags = ["--scene", scn, "--spp", "64", "--max-bounces",
                 str(BOUNCES), "--no-dof"]
        images = {}
        for n in [1] + [n for n in ranks if n > 1]:
            out = os.path.join(tmp, f"r{n}.hdr")
            if n == 1:
                argv = [sys.executable, "-m", "offline_raytracer_tpu_torch.cli",
                        *flags, "--ray-batch", str(512 * 512), "--out", out]
            else:
                argv = [sys.executable, "-m", "torch.distributed.run",
                        "--nproc-per-node", str(n), "--master-port",
                        str(free_port()), "-m",
                        "offline_raytracer_tpu_torch.cli", "--multihost",
                        *flags, "--out", out]
            t0 = time.time()
            r = subprocess.run(argv, capture_output=True, text=True, env=env,
                               timeout=1200)
            if r.returncode != 0:
                raise RuntimeError(f"{argv}: {r.stderr[-4000:]}")
            line = json.loads(r.stdout.strip().splitlines()[-1])
            images[n] = hdr.read_hdr(out)
            print(json.dumps({"cli_ranks": n, **line,
                              "process_wall_s": time.time() - t0,
                              "image_equal_to_1_rank": bool(np.array_equal(
                                  images[n], images[1])),
                              "card": card}), flush=True)


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--cli", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("parallel_scaling: no CUDA device", file=sys.stderr)
        return 1
    from offline_raytracer_tpu_torch.parallel.shard import run_ranks

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    ranks = [n for n in args.ranks if n <= n_cards]
    print(f"{n_cards} cards: {card}; rank counts {ranks}", flush=True)
    for n in ranks:
        res = run_ranks(measure_rank, n, args.samples, device="cuda",
                        timeout_s=600, deadline_s=1200)[0]
        print(json.dumps({**res, "card": card[0]}), flush=True)
    if args.cli:
        cli_runs(ranks, card[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
