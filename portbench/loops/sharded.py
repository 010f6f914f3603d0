"""``sharded``: the sharded render across the cell's cards.

One rank a card, started inside the run by ``parallel.shard.run_ranks``
(NCCL on the card, gloo on the CPU), each running
``sharded_ranks.rank_window``: every pixel id in the tile order, the same
on every rank, is split over the ranks, and each call
``shard.render_block_sharded(scene, cfg, group, ids, n * k, n)`` renders
the rank's block's ``n`` samples and all-gathers the image, until
``--seconds`` have passed. The window is the slowest rank's; a call's wall
is the slowest rank's for that call; the rays are every rank's, from the
segment launches' alive counts. Every rank keeps the rows of each gathered
image drawn for the comparison, and each rank's rows are compared with the
plain reference's mean over the call's ``n`` samples of the same pixels.
Parameters of the traffic file:

- ``samples_per_call``: ``n``, the samples rendered between two gathers;
- ``warmup_calls``: calls of samples outside the window's, in set-up;
- ``check_rows_per_call``: pixels of each gathered image kept for the
  comparison, drawn from the seed;
- ``trace_calls``: calls profiled on every rank in a ``--trace 1`` run
  (the first of the window), with the program's recorder on: each must
  make one ``shard.all_gather`` span whose ``shard.bytes`` are the whole
  image's, or the run fails. Rank 0's trace is the run's.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import raycount
from portbench.common import draw_pool, reference_setup
from portbench.harness import Record
from portbench.trace import TraceReading

# seconds every collective of a rank waits for its slowest peer
RANK_TIMEOUT_S = 600.0


def ranks(ctx) -> int:
    return int(ctx.cell.workload["chips"])


def gather_check(traces: list, want_calls: int):
    """Fail the run unless every traced rank made one ``shard.all_gather``
    a traced call, and counted the whole image's bytes for each."""
    for r, t in enumerate(traces):
        if t["gathers"] != want_calls or t["bytes"] != (
                t["image_bytes"] * want_calls):
            raise SystemExit(
                f"trace check: rank {r} made {t['gathers']} shard.all_gather"
                f" spans of {t['bytes']} bytes over {want_calls} traced "
                f"calls, want one of {t['image_bytes']} bytes each")


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.cell.traffic

    def measure(self) -> Record:
        import torch
        from offline_raytracer_tpu_torch.config import RenderConfig
        from offline_raytracer_tpu_torch.parallel import shard

        from portbench import sharded_ranks
        from portbench.inputs import recipe

        ctx = self.ctx
        # the process's start on the wall clock, which the ranks share
        start_wall = time.time() - (time.perf_counter() - ctx.t_start)
        cfg = RenderConfig(**ctx.render, seed=ctx.seed32)
        P = cfg.width * cfg.height
        size = ranks(ctx)
        if P % size:
            raise SystemExit(f"{P} pixels do not split over {size} ranks")
        self.ids = recipe.tile_pixel_ids(cfg.width, cfg.height)
        K = int(self.tr["check_rows_per_call"])
        self.pool = draw_pool(P, K, ctx.seed, "cpu")
        n = int(self.tr["samples_per_call"])
        n_trace = int(self.tr["trace_calls"]) if ctx.trace else 0
        spec = {"render": ctx.render, "seed32": ctx.seed32,
                "made": ctx.made, "camera": ctx.camera,
                "pool": self.pool.numpy(), "samples_per_call": n,
                "warmup_calls": int(self.tr["warmup_calls"]),
                "trace_calls": n_trace, "seconds": ctx.seconds}
        on_card = torch.device(ctx.device).type == "cuda"
        kw = {} if on_card else {"threads": 1}
        outs = shard.run_ranks(
            sharded_ranks.rank_window, size, spec, device=ctx.device,
            timeout_s=RANK_TIMEOUT_S, deadline_s=ctx.seconds + 1800.0,
            **kw)
        calls = {o["calls"] for o in outs}
        if len(calls) != 1:
            raise SystemExit(f"the ranks made different calls: {calls}")
        self.n, self.K, self.samples = calls.pop(), K, n
        window_s = max(o["window_s"] for o in outs)
        setup_s = max(o["t_first_wall"] for o in outs) - start_wall
        call_s = list(np.max([o["call_s"] for o in outs], axis=0))
        alive = np.sum([o["alive"] for o in outs], axis=0)
        paths = sum(o["paths"] for o in outs)
        nee = bool(cfg.enable_nee and recipe.counts(ctx.made)["lights"])
        rays = raycount.launch_rays(paths, alive, nee)
        self.kept = [torch.from_numpy(o["kept"]) for o in outs]
        self.alive_share = alive / paths
        for o in outs:
            print(f"rank {o['rank']}: {o['calls']} calls, window "
                  f"{o['window_s']:.3f} s, call ms median "
                  f"{np.median(o['call_s']) * 1e3:.3f}, memory peak "
                  f"{o['memory_peak_bytes']} bytes", file=sys.stderr)
        ms = np.asarray(call_s) * 1e3
        print(f"call ms (slowest rank): median {np.median(ms):.3f}, p95 "
              f"{np.percentile(ms, 95):.3f}, max {ms.max():.3f}",
              file=sys.stderr)
        reading, traces = None, [o["trace"] for o in outs if "trace" in o]
        if n_trace:
            gather_check(traces, min(n_trace, self.n))
            t0 = traces[0]
            reading = TraceReading(kernels=t0["kernels"], host=t0["host"],
                                   window_s=t0["window_s"],
                                   launches=t0["calls"])
        return Record(
            setup_s=setup_s, window_s=window_s, attempted=self.n,
            spans=dict(ctx.spans), trace=reading,
            values={"rays": rays, "launch_s": call_s, "ranks": traces,
                    "memory_peak_bytes": [o["memory_peak_bytes"]
                                          for o in outs]})

    def free(self):
        """The ranks' processes have ended, and their state with them."""

    def compare(self) -> dict:
        import torch

        from portbench import check
        from portbench.reference.paths import trace

        ctx = self.ctx
        sc, cfg = reference_setup(ctx)
        dev = torch.device(ctx.device)
        ids = torch.from_numpy(self.ids).to(dev)
        n, K = self.samples, self.K
        rows = self.pool[:self.n].to(dev)
        pix = ids[rows].reshape(-1)                       # (calls * K,)
        # sample j of call k is n * k + j; each row the mean of its n
        calls = torch.arange(self.n, device=dev).repeat_interleave(K)
        smp = (n * calls[:, None] + torch.arange(n, device=dev)).reshape(-1)
        rad, alive = trace(sc, cfg, pix.repeat_interleave(n), smp)
        ref = rad.reshape(-1, n, 3).mean(1)
        worst = max(check.path_mismatch_pct(kept, ref) for kept in self.kept)
        share = alive.float().mean(1).cpu().numpy()
        print("alive shares, program / reference: " + " ".join(
            f"{a:.5f}/{b:.5f}" for a, b in zip(self.alive_share, share)),
            file=sys.stderr)
        return {"path_mismatch_pct": worst,
                "alive_z": check.alive_z(self.alive_share, alive)}


def control(ctx, launches: int, precision: str, fault=None) -> dict:
    """The comparison's numbers with the reference at ``precision`` in the
    program's place, over the check rows of ``launches`` calls."""
    import torch

    from portbench import check
    from portbench.inputs import recipe
    from portbench.reference.paths import trace

    if fault is not None:
        raise SystemExit("a render cell's control plants no fault")
    sc, cfg = reference_setup(ctx)
    dev = torch.device(ctx.device)
    ids = torch.from_numpy(recipe.tile_pixel_ids(cfg.width, cfg.height)).to(
        dev)
    K = int(ctx.cell.traffic["check_rows_per_call"])
    n = int(ctx.cell.traffic["samples_per_call"])
    pool = draw_pool(ids.shape[0], K, ctx.seed, "cpu")[:launches].to(dev)
    pix = ids[pool].reshape(-1).repeat_interleave(n)
    calls = torch.arange(launches, device=dev).repeat_interleave(K)
    smp = (n * calls[:, None] + torch.arange(n, device=dev)).reshape(-1)
    got, got_alive = trace(sc, cfg, pix, smp, precision)
    ref, alive = trace(sc, cfg, pix, smp)
    return {"paths": int(pix.shape[0]),
            "path_mismatch_pct": check.path_mismatch_pct(
                got.reshape(-1, n, 3).mean(1), ref.reshape(-1, n, 3).mean(1)),
            "alive_z": check.alive_z(
                got_alive.float().mean(1).cpu().numpy(), alive)}

