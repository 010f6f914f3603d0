"""What each rank of the ``sharded`` loop (``loops/sharded.py``) runs, in a
process of its own that ``parallel.shard.run_ranks`` starts: a module of
the package, so that the spawned processes can import it by name.

``rank_window(group, spec)`` builds the scene on the rank's device from the
recipe's calls, warms up, and then calls
``shard.render_block_sharded(scene, cfg, group, ids, n * k, n)`` (every
pixel id, the same on every rank, split over the ranks; each rank renders
its block's ``n`` samples and the image is all-gathered) for k = 0, 1, 2,
... until ``seconds`` have passed on some rank: after each call the ranks
agree whether to go on (a max all-reduce of one flag), so every rank makes
the same calls. Each call's wall is taken from its start to the end of a
device synchronisation. The segment launches' alive counts are read by
wrapping ``mega.render_paths_mega`` to collect its stats (the radiance it
returns is the same). With ``trace_calls``, the first calls of the window
run with the program's recorder on under ``spans.SpanTracer``, whose
reading this rank summarises. Returns numpy and Python numbers only.
"""

from __future__ import annotations

import time

# samples of the warm-up calls: far from the window's 0, 1, 2, ...
WARM_SAMPLE = 1 << 30


def _summary(reading, calls: int, image_bytes: int, events: bool) -> dict:
    """A traced rank's numbers: device seconds inside the program's
    ``shard.all_gather`` spans and outside them over the traced calls, the
    spans and their bytes; with ``events``, the trace's device operations
    and host operators too."""
    from portbench.spans import attribution

    a = attribution(reading)
    program = reading.program or {"spans": [], "counters": {}}
    gathers = sum(s["name"] == "shard.all_gather"
                  for s in program["spans"])
    total = reading.device_s()
    gather_s = (a["device_s"].get("shard.all_gather", 0.0)
                if a and reading.kernels else None)
    return {"calls": calls, "gathers": gathers,
            "bytes": program["counters"].get("shard.bytes"),
            "image_bytes": image_bytes,
            "gather_s": gather_s,
            "compute_s": None if gather_s is None else total - gather_s,
            "busy_s": reading.busy_s(), "window_s": reading.window_s,
            "kernels": reading.kernels if events else [],
            "host": reading.host if events else []}


def rank_window(group, spec: dict) -> dict:
    import torch
    import torch.distributed as dist

    from offline_raytracer_tpu_torch.config import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.parallel import shard
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder
    from offline_raytracer_tpu_torch.utils import profiling

    from portbench.inputs import recipe
    from portbench.spans import SpanTracer

    dev = group.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = RenderConfig(**spec["render"], seed=spec["seed32"])
    b = recipe.apply(SceneBuilder(), spec["made"], spec["camera"])
    scene = b.build(cfg.width, cfg.height, device=dev)
    ids = torch.from_numpy(
        recipe.tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    pool = torch.from_numpy(spec["pool"]).to(dev)
    n = int(spec["samples_per_call"])
    P = ids.shape[0]

    alive_acc = []
    original = mega.render_paths_mega

    def counting(*args, collect_stats=False, **kw):
        rad, alive = original(*args, collect_stats=True, **kw)
        alive_acc.append(alive)
        return (rad, alive) if collect_stats else rad

    mega.render_paths_mega = counting
    # gloo reads host memory (shard._wire), NCCL the card's
    flag = torch.zeros((1,), dtype=torch.float32,
                       device="cpu" if group.backend == "gloo" else dev)
    n_trace = int(spec["trace_calls"])
    tracer = reading = None
    n_warm = int(spec["warmup_calls"])
    try:
        with torch.no_grad():
            if n_trace:
                tracer = SpanTracer(n_warm, n_trace)
                tracer.start()
            for w in range(n_warm):
                shard.render_block_sharded(scene, cfg, group, ids,
                                           WARM_SAMPLE + n * w, n)
                sync()
                if tracer is not None:
                    tracer.step()
            alive_acc.clear()
            if tracer is not None:
                profiling.flush()
                profiling.enable()
            if group.group is not None:
                dist.barrier(group=group.group)
            t_first_wall = time.time()
            t_first = time.perf_counter()
            deadline = t_first + float(spec["seconds"])
            call_s, kept = [], []
            k = 0
            while True:
                t0 = time.perf_counter()
                img = shard.render_block_sharded(scene, cfg, group, ids,
                                                 n * k, n)
                sync()
                t1 = time.perf_counter()
                call_s.append(t1 - t0)
                kept.append(img[pool[k]].cpu())
                if k < n_trace:
                    tracer.step()
                    if k == n_trace - 1:
                        reading = tracer.stop(t1 - t_first, n_trace)
                        profiling.disable()
                k += 1
                flag.fill_(float(t1 >= deadline or k == pool.shape[0]))
                if group.group is not None:
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                    group=group.group)
                if flag.item() > 0:
                    break
            window_s = time.perf_counter() - t_first
            if tracer is not None and reading is None:
                reading = tracer.stop(window_s, k)
                profiling.disable()
    finally:
        mega.render_paths_mega = original
        profiling.disable()
    alive = torch.stack(alive_acc).sum(0).double().cpu().numpy()
    out = {"rank": group.rank, "calls": k, "call_s": call_s,
           "window_s": window_s, "t_first_wall": t_first_wall,
           "alive": alive, "paths": P // group.size * n * k,
           "kept": torch.cat(kept).numpy(),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
           if on_card else 0}
    if reading is not None:
        out["trace"] = _summary(reading, reading.launches, P * 3 * 4,
                                events=group.rank == 0)
    return out
