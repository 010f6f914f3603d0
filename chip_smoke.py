#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels (``KERNELS``: ``csrc/mega.cu``,
   ``csrc/traverse_cull.cu``, ``csrc/traverse_packet.cu``,
   ``csrc/threefry.cu``, ``csrc/sphere_sweep.cu``, ``csrc/wave_shade.cu``,
   ``csrc/light_sample.cu``) from this checkout, one nvcc each, at once;
3. hold the segment kernel against its plain PyTorch version on the exact
   segment inputs the main path produces: a 16,384-ray probe of the bunny
   stand-in (every 16th ray of the tile order, so it spans the whole image
   and the mesh; its bounce-0 segment, which must hit triangles, and its fused
   tail) and of a scene with cylinders and box/cylinder lights; then the
   analytic scene's render against the committed golden image; then the
   four segments of one full-size sample (262,144 rays), each run at one
   lane per ray and at the lanes per ray ``mega.group_size`` picks, which
   must give bitwise the same outputs, with each one's kernel ms, and the
   light-sample kernel (``csrc/light_sample.cu``) on each one's uniforms,
   its planes, the planes the main path handed the segment and the plain
   twin's bitwise equal, each timed beside its bytes bound; then the
   threefry kernel's draws of that sample (its per-ray keys, the camera's
   uniforms and each segment's planes, 262,144 rays), each bitwise equal
   to the plain int64 version's and timed against it and its bound;
4. the slice: ``render_block_stats`` over the image of the bunny stand-in
   (a procedural mesh of 69,451 triangles, as many as bunny.ply, in the
   bunny configuration) at 512x512, 32 spp, 8 bounces, DOF off, one launch
   per sample, with the segment tables built once as ``render_image`` does,
   counting rays after the loop as bench.py does, and checking that every
   segment went through the kernel, every segment's light planes through
   the light-sample kernel and every draw through the threefry kernel (one
   launch per segment and two per sample);
5. the wavefront route's triangle queries: the inputs of the 16 queries
   of one full-size wavefront sample (262,144 rays, 8 bounces, NEE on:
   per bounce a closest-hit and a shadow any-hit query) are captured, and
   on each the cull-and-sweep kernel (``csrc/traverse_cull.cu``) and the
   tree walk kernel (``csrc/traverse_packet.cu``) are held against the
   plain dense sweep (bounce 0's closest hit must hit triangles), every
   lanes-per-ray G against G = 1 bit for bit, and each is timed at the
   lanes per ray its wrapper picks, beside its bound; the sums over the
   16 queries are the per-sample times;
6. the wavefront slice: ``render_block_stats`` over the whole 512x512
   stand-in image with ``traversal="cull"`` and again with "packet", 4 spp
   each, every launch counted (one closest-hit and one shadow query per
   bounce and sample), with the peak device memory;
7. the cross-check of ``bench.py:69-85``: a 4,096-pixel probe (every 64th
   pixel of the tile order) at 2 spp through the segment, cull and packet
   routes, with that check's bounds;
8. the gradient step of ``bench.py:234-285`` on the stand-in: the first
   65,536 pixels of the tile order, 1 spp, 8 bounces, loss
   ``mean(render_block(...))``, gradients with respect to the albedo and
   the mesh's ``v0``, ``grad_mode="replay-value"`` (segment launches with
   records, then the replay of the records under autograd): 1 untimed and 4
   timed steps with one sync, fwd+bwd Mrays/s counted as bench.py counts,
   4 segment launches per step and none of the traversal kernels, at least
   one threefry launch per segment and two per step (the replay draws
   more), finite
   nonzero gradients equal to the kernel-value route's, the kernel's
   radiance against its replay's and its records against the plain
   version's on the step's rays;
9. inverse rendering (``diff.optimize``) on the same pixels: the stand-in's
   albedo set wrong, 8 Adam steps of 4 spp at lr 0.1 towards an 8-spp
   render of the true scene; the loss of the result on the first step's
   samples must be below the first step's, and the albedo nearer the
   truth;
10. the command line, the user's path: the stand-in mesh written as an
   ASCII .ply beside a small .obj and a .scn of every keyword
   (``tests/torch_port_cases.write_scene_files``: screen 512x512), loaded
   once to time the load and the LBVH build and to check that it takes the
   segment route, then rendered by ``cli.main`` in this process at 8 spp,
   8 bounces, DOF off, ``--ray-batch 262144 --meter --png``: exactly the
   segment launches of 8 samples and no traversal launch, the .hdr read
   back equal to the image within RGBE rounding; then the resume surgery of
   ``tests/test_checkpoint.py:53-77`` through ``--checkpoint`` at 8 spp in
   chunks of 4 (an uninterrupted run; a 4-spp run relabelled as a paused
   8-spp run; the resumed run), whose image must be bitwise the
   uninterrupted one, and near the tile-order render's;
11. ``parallel/``: (a) one NCCL rank in this process renders the stand-in
   through ``render_image_sharded`` at 512x512, 4 spp, 8 bounces: exactly 4
   segment launches per sample and none of the traversal kernels, the image
   equal to the single-process render of the same pixels (rtol 1e-5 / atol
   1e-6, the count of differing values printed); (b) two ranks on the one
   card, spawned by ``parallel/shard.run_ranks`` with gloo (NCCL takes one
   rank per card), render the same image sharded, equal to (a)'s, then
   take ``grad_step_sharded`` on phase 8's 65,536 pixels at 1 spp (d/d
   albedo and d/d ``v0``, replay-value, a zero target), 4 segment launches
   per rank, loss and gradients equal to the same step in one process
   within rtol 1e-4 / atol 1e-7; (c) the same two ranks split the stand-in
   into 2 Morton shards, one each, and render 512x512 at 1 spp through the
   ring with ``traversal="auto"``: exactly 2 * 2 * 8 cull launches per rank
   (per bounce 2 closest-hit and 2 shadow ring steps) and nothing else, the
   image within rtol 1e-4 / atol 1e-5 of the replicated cull render, each
   rank's BVH bytes on the card against the replicated tables'; then phase
   7's probe through the ring with ``traversal="packet"`` against the
   replicated packet route. Each part prints its backend and wall seconds;
12. the wavefront route's sphere sweep (``csrc/sphere_sweep.cu``) on the
   final scene of *Ray Tracing in One Weekend* (``portbench/configs/
   rtiow_final.json``: 486 spheres, 1200x675): the closest-hit query of
   bounce 10 of one sample of all 810,000 pixels is captured with its
   alive mask, the sample's 11 bounces launching the kernel exactly 11
   times, and the kernel, with the mask and over every lane, is held
   against the plain ``sphere_ts(...).min(-1)`` over every lane: the same
   winners and distances, bit for bit, on every lane it answers, a dead
   lane a miss; each timed with CUDA events beside its bound
   (the bytes of ``portbench/roofline_wave.hit_bound_ms`` and the pair
   tests at the card's FP32 issue rate, whichever is larger);
13. the wavefront route's shading kernel (``csrc/wave_shade.cu``) on the
   same full-size sample: bounces 0 and 10 of its 11 are captured (the
   sample launching the kernel exactly once a bounce) and each is shaded
   through the kernel, into new planes and in place, and through the eager
   body (``integrator.shade_bounce``), every output plane bit for bit on
   every lane; each timed with CUDA events, the bounce's draws included,
   beside its bound (``shade_bound``).

The line before the last is the kernels' JSON record (each kernel's
launches on its route, its error and time against its plain version, its
bound on this card from the bytes and operations of the same inputs, and
the library call that computes the same function: none does; for the two
traversal kernels times and bounds are per sample, summed over its 16
queries, with each query's beside them, and for the threefry kernel
summed over a sample's 6 calls, with each call's beside them, and for the
sphere sweep the masked query of phase 12, with the every-lane one beside
it, and for the shading kernel bounce 10 in place, with bounce 0 beside
it); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
W = H = 512
SPP = 32
BOUNCES = 8
PROBE = 16384
N_TRIS = 69451
RECORD_BUDGET = 0.002     # share of live (id, vis) records allowed to differ
WSPP = 4                  # samples of the wavefront slice, per route
QUERY_BUDGET = 0.002      # share of live rays whose slot or bit may differ
GRAD_PIXELS = 1 << 16     # pixels of the gradient step (bench.py's gids)
GRAD_STEPS = 4            # timed gradient steps
INV_STEPS = 8             # Adam steps of the inverse-rendering phase
INV_SPP = 4               # samples per pixel of each of its steps
WRONG_ALBEDO = (0.1, 0.8, 0.8)
CLI_SPP = 8               # samples per pixel of the command line's renders
CLI_EVERY = 4             # their checkpoint chunk
PAR_SPP = 4               # samples per pixel of the sharded renders
RING_SPP = 1              # and of the ring's render
KERNELS = ("mega", "traverse_cull", "traverse_packet", "threefry",
           "sphere_sweep", "wave_shade", "light_sample")
# the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# float32 operations each step needs at least: a slab test of one box
# (6 subtractions, 6 products, 6 min/max and 2 compares), the plane part
# of a triangle test (two 3-term dot products, one division, 2 compares),
# the shading of one bounce (BSDF sample, evaluation and pdf, twice with
# NEE: a few hundred)
SLAB_FLOP = 20
TRI_FLOP = 13
SHADE_FLOP = 300
# a threefry-2x32 block's 20 funnel shifts and 20 xors, which only the
# integer ALU pipe runs (its adds may go to the FMA pipe), at 64 a clock on
# each of the card's 132 SMs at its 1.98 GHz boost clock
THREEFRY_ALU_OPS = 40
PEAK_ALU_OPS = 64 * 132 * 1.98e9
# a ray-sphere test's float32 operations up to its discriminant's sign (3
# subtractions, 7 products, 4 additions, 2 subtractions, a compare; the root
# only where it is positive), none fusable: issued one a lane a clock on
# the card's 128 FP32 lanes of each of 132 SMs at 1.98 GHz
SPHERE_TEST_OPS = 17
PEAK_FP32_ISSUE = 128 * 132 * 1.98e9
SWEEP_BOUNCE = 10         # the bounce whose closest-hit query phase 12 takes
# bytes the shading kernel moves a lane: a live one reads its hit (21), its
# state (53), its 8 uniforms (32) and its material's rows (57) and writes
# its state (53); a dead one reads its alive byte, and when the kernel
# writes new planes copies its direction, throughput and radiance and
# writes its origin, alive byte and prev_pdf (37 + 53)
SHADE_LIVE_BYTES = 216
SHADE_DEAD_BYTES = 1
SHADE_DEAD_COPY_BYTES = 90
SHADE_BOUNCES = (0, SWEEP_BOUNCE)   # the bounces phase 13 takes
# bytes the light-sample kernel moves a lane and bounce: its 4 uniforms
# read and its 10 planes written (the light table stays in the cache)
LIGHT_LANE_BYTES = 56


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bunny_stand_in(device, size=W):
    """The bunny configuration around a procedural mesh of as many
    triangles as bunny.ply, scaled to bunny.ply's extent (bunny_builder
    then scales by 8), for a size x size image (512 x 512 by default)."""
    from offline_raytracer_tpu_torch.models.scenes import bunny_builder
    from torch_port_cases import procedural_mesh

    v, f = procedural_mesh(N_TRIS)
    return bunny_builder(v * 0.075, f).build(size, size, device=device)


def capture_segments(scene, cfg, pixel_ids):
    """Run one sample of the main path on the card and keep every
    segment's inputs: [(state, u, ls, tables, seg)]."""
    import torch
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.utils import rng

    seen = []
    original = mega.mega_segment

    def recording(state, u, ls, tables, seg):
        seen.append((state.clone(), u.clone(), ls.clone(), tables, seg))
        return original(state, u, ls, tables, seg)

    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, pixel_ids.device),
                                 pixel_ids, torch.zeros_like(pixel_ids))
    ro, rd = generate_rays(scene.camera, cfg, pixel_ids, keys)
    mega.mega_segment = recording
    try:
        mega.render_paths_mega(scene, cfg, ro, rd, keys)
    finally:
        mega.mega_segment = original
    return seen


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time this card could take to move
    nbytes once and do flops float32 operations."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def segment_bound(inputs, rad):
    """Bound of one segment launch: every ray's state read and written and
    its radiance and records written; the tables read once; for each
    ray-bounce live at its start, the uniforms the kernel reads there (4
    planes: roulette and BSDF sample) and, with NEE, the light sample (10
    planes). Operations from this run's records (per live ray and bounce,
    the shading and the two root slab tests of each query; per triangle
    hit, a walk to the leaf's depth, the leaf's sub-boxes and one sub-box's
    triangles)."""
    import torch
    from offline_raytracer_tpu_torch.ops import bvh

    state, _, _, tables, seg = inputs
    nf = seg.n_fused
    alive_in = state[10:11] > 0.5
    live = torch.cat([alive_in, rad[3 + 2 * nf:3 + 3 * nf - 1] > 0.5], 0)
    n_live = int(live.sum())
    live_planes = 4 + (10 if seg.do_nee else 0)
    nbytes = 4 * (2 * state.numel() + rad.numel() + n_live * live_planes
                  + tables.consts.numel() + tables.tri_lm.numel()
                  + tables.sub.numel() + tables.tri_mat.numel()
                  + tables.nodes.numel())
    tri = int(((rad[3:3 + nf] >= tables.meta.tri_base) & live).sum())
    depth = max(tables.n_leaves.bit_length() - 1, 0)
    flops = (n_live * (SHADE_FLOP + 2 * 2 * SLAB_FLOP)
             + tri * ((2 * depth + bvh.SUB) * SLAB_FLOP
                      + bvh.SUB_TRIS * TRI_FLOP))
    return bound(nbytes, flops)


def group_times(inputs, groups, reps=5):
    """{G: kernel ms} of one segment's inputs at each lanes-per-ray G;
    raises unless every G gives bitwise the same outputs as G = 1."""
    import torch
    from offline_raytracer_tpu_torch.ops import mega

    state, u, ls, tables, seg = inputs
    ref = mega.mega_segment_cuda(state, u, ls, tables, seg, group=1)
    out = {}
    for g in groups:
        got = mega.mega_segment_cuda(state, u, ls, tables, seg, group=g)
        for name, r, k in zip(("state", "rad"), ref, got):
            differ = int((r.view(torch.int32) != k.view(torch.int32)).sum())
            if differ:
                raise AssertionError(
                    f"segment b={seg.b_start}: G={g} {name} differs from "
                    f"G=1 in {differ} values")
        out[g] = time_ms(lambda: mega.mega_segment_cuda(
            state, u, ls, tables, seg, group=g), reps)
    return out


def ptxas_summary(log):
    """'kernel: registers, stack frame and spills' of each kernel entry in
    an nvcc -Xptxas -v log."""
    rows, entry, props, frame = [], None, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, frame = m.group(1), ""
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        if "stack frame" in ln and props == entry:
            frame = ln.strip()
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            k = re.search(r"\d([a-z]+_kernel)I((?:L[bi]\d+E)+)", entry)
            name = entry if not k else k.group(1) + "<" + ",".join(
                ("ANY=" if t == "b" else "G=") + v
                for t, v in re.findall(r"L([bi])(\d+)E", k.group(2))) + ">"
            rows.append(f"{name}: {m.group(1)} registers, {frame}")
            entry = None
    return rows


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_segment(name, inputs):
    """Kernel vs plain version on one segment's inputs; returns the
    measurements. Raises on a disagreement beyond the mega test's bounds."""
    import numpy as np
    import torch
    from offline_raytracer_tpu_torch.ops import mega
    from torch_port_cases import assert_close

    state, u, ls, tables, seg = inputs
    nf = seg.n_fused
    k_state, k_rad = mega.mega_segment_cuda(state, u, ls, tables, seg)
    p_state, p_rad = mega.mega_segment_plain(state, u, ls, tables, seg)
    torch.cuda.synchronize()
    b_ms, b_by = segment_bound(inputs, k_rad)
    k_rad, p_rad = k_rad.cpu().numpy(), p_rad.cpu().numpy()
    alive_in = state[10].cpu().numpy() > 0.5
    k_alive = k_rad[3 + 2 * nf:] > 0.5
    live = np.concatenate([alive_in[None], k_alive[:-1]], 0)
    differ = ((k_rad[3:3 + nf] != p_rad[3:3 + nf])
              | (k_rad[3 + nf:3 + 2 * nf] != p_rad[3 + nf:3 + 2 * nf])) & live
    n_live = int(live.sum())
    n_differ = int(differ.sum())
    if n_differ > RECORD_BUDGET * max(n_live, 1):
        raise AssertionError(
            f"{name}: {n_differ} of {n_live} live records differ")
    k_count = k_rad[3 + 2 * nf:].sum(1)
    p_count = p_rad[3 + 2 * nf:].sum(1)
    if np.abs(k_count - p_count).max() > n_differ:
        raise AssertionError(
            f"{name}: alive counts {k_count} vs {p_count}")
    tri_hits = int(((k_rad[3:3 + nf] >= tables.meta.tri_base) & live).sum())
    ref, got = p_rad[0:3].T, k_rad[0:3].T
    assert_close(ref, got)
    err = float(np.abs(ref - got).max())
    k_ms = time_ms(lambda: mega.mega_segment_cuda(state, u, ls, tables, seg),
                   10)
    p_ms = time_ms(lambda: mega.mega_segment_plain(state, u, ls, tables, seg),
                   2)
    g = mega.group_size(seg, state.shape[1])
    log(f"  {name}: Rp={state.shape[1]} nf={nf} live={n_live} "
        f"triangle_hits={tri_hits} records_differ={n_differ} "
        f"alive kernel={k_count.tolist()} plain={p_count.tolist()} "
        f"max_abs_err={err:.3e} kernel_ms={k_ms:.4f} (G={g}) "
        f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "tri_hits": tri_hits,
            "bound_ms": b_ms, "bound_by": b_by, "group": g}


def compare_light_planes(scene, inputs):
    """The light-sample kernel against its plain twin on one captured
    segment's uniforms: both, and the planes the main path handed the
    segment, bitwise equal; each timed. Returns (kernel ms, plain ms,
    bound ms)."""
    import torch
    from offline_raytracer_tpu_torch.ops import light_sample

    _, u, ls, _, seg = inputs
    nf = seg.n_fused
    args = (u, nf, scene.lights, scene.materials.emit)
    k = light_sample.sample_planes_cuda(*args)
    p = light_sample.sample_planes_plain(*args)
    torch.cuda.synchronize()
    for name, got in (("kernel", k), ("main path's", ls)):
        differ = int((got.view(torch.int32) != p.view(torch.int32)).sum())
        if got.shape != p.shape or differ:
            fail(f"light sample b={seg.b_start}: the {name} planes differ "
                 f"bitwise from the plain twin's in {differ} of "
                 f"{p.numel()} values")
    k_ms = time_ms(lambda: light_sample.sample_planes_cuda(*args), 10)
    p_ms = time_ms(lambda: light_sample.sample_planes_plain(*args), 3)
    b_ms = u.shape[1] * nf * LIGHT_LANE_BYTES / PEAK_BYTES * 1e3
    return k_ms, p_ms, b_ms


def capture_queries(scene, cfg, pixel_ids):
    """Run one wavefront sample (the cull route) on the card and keep
    every triangle query's inputs, in call order: [(tables, ro, rd, t_far,
    any_hit)]. Per bounce: the closest-hit query, then the shadow query."""
    import torch
    from offline_raytracer_tpu_torch.ops import traverse_cull
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.render import _paths_fn
    from offline_raytracer_tpu_torch.utils import rng

    seen = []
    original = traverse_cull.bvh_hit_ts_cull

    def recording(tables, ro, rd, t_min, t_far=None, any_hit=False):
        seen.append((tables, ro.clone(), rd.clone(),
                     None if t_far is None else t_far.clone(), any_hit))
        return original(tables, ro, rd, t_min, t_far, any_hit)

    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, pixel_ids.device),
                                 pixel_ids, torch.zeros_like(pixel_ids))
    ro, rd = generate_rays(scene.camera, cfg, pixel_ids, keys)
    traverse_cull.bvh_hit_ts_cull = recording
    try:
        _paths_fn(scene, cfg.replace(traversal="cull"))(ro, rd, keys)
    finally:
        traverse_cull.bvh_hit_ts_cull = original
    return seen


def query_bound(kname, query, t_min, hits):
    """(bound_ms, bound_by) of one triangle query by kernel ``kname``: the
    rays, their bounds and the tables that kernel reads (leaf boxes or
    tree nodes, the leaf-major coefficients, the sub-boxes) read once,
    (t, slot) written once; per live ray two root slab tests, per hit a
    walk to the leaf's depth, the leaf's sub-boxes and one sub-box's
    triangles (the segment bound's operation count)."""
    from offline_raytracer_tpu_torch.ops import bvh, traverse

    tables, ro, rd, tf, _ = query
    R = ro.shape[0]
    cull = (tables.leaf_bounds if kname == "traverse_cull"
            else tables.nodes)
    nbytes = 4 * (ro.numel() + rd.numel() + (0 if tf is None else R)
                  + cull.numel() + tables.tri_lm.numel()
                  + tables.sub.numel() + 2 * R)
    n_live = int(traverse.live_rays(ro, tf, t_min).sum())
    depth = max(tables.n_leaves.bit_length() - 1, 0)
    return bound(nbytes, n_live * 2 * SLAB_FLOP + hits * (
        (2 * depth + bvh.SUB) * SLAB_FLOP + bvh.SUB_TRIS * TRI_FLOP))


def compare_query(b, query, t_min):
    """Both kernels vs the plain dense sweep on one captured query of the
    full-size sample: slots (closest hit) or occlusion bits (any hit) on
    the live rays within QUERY_BUDGET, t within 1e-5 relative where slots
    agree, every G bitwise equal to G = 1. Raises beyond the bounds;
    returns (live rays, {kernel: measurements}): the query through the
    wrapper at the G it picks, over 5 launches; the plain sweep timed
    once."""
    import numpy as np
    import torch
    from offline_raytracer_tpu_torch.ops import (
        traverse, traverse_cull, traverse_packet)

    tables, ro, rd, tf, any_hit = query
    live = traverse.live_rays(ro, tf, t_min).cpu().numpy()
    n_live = max(int(live.sum()), 1)
    torch.cuda.synchronize()
    t0 = time.time()
    p_t, p_s = (x.cpu().numpy() for x in traverse.tri_hit_plain(
        tables, ro, rd, t_min, tf, any_hit))
    p_ms = (time.time() - t0) * 1e3
    out = {}
    for kname, mod in (("traverse_cull", traverse_cull),
                       ("traverse_packet", traverse_packet)):
        fn = getattr(mod, f"bvh_hit_ts_{kname.split('_')[1]}_cuda")
        k_t, k_s = (x.cpu().numpy() for x in fn(tables, ro, rd, t_min, tf,
                                               any_hit))
        if any_hit:
            differ = ((k_s >= 0) != (p_s >= 0)) & live
        else:
            differ = (k_s != p_s) & live
        if differ.sum() > QUERY_BUDGET * n_live:
            raise AssertionError(f"bounce {b} {kname}: {int(differ.sum())} "
                                 f"of {n_live} live rays differ")
        both = (k_s == p_s) & (k_s >= 0) & live
        err = float(np.abs(k_t[both] - p_t[both]).max()) if both.any() else 0.0
        rel = (np.abs(k_t[both] - p_t[both])
               / np.abs(p_t[both])).max() if both.any() else 0.0
        if not any_hit and rel > 1e-5:
            raise AssertionError(f"bounce {b} {kname}: t rel err {rel:.3e}")
        ref = fn(tables, ro, rd, t_min, tf, any_hit, group=1)
        for g in traverse.GROUPS[1:]:
            got = fn(tables, ro, rd, t_min, tf, any_hit, group=g)
            for r, k in zip(ref, got):
                if not torch.equal(r.view(torch.int32), k.view(torch.int32)):
                    raise AssertionError(f"bounce {b} {kname}: G={g} differs "
                                         f"from G=1")
        hits = int((k_s >= 0).sum())
        b_ms, b_by = query_bound(kname, query, t_min, hits)
        out[kname] = {"ms": time_ms(lambda: fn(tables, ro, rd, t_min, tf,
                                               any_hit), 5),
                      "group": traverse.group_size(ro.shape[0]),
                      "plain_ms": p_ms, "err": err, "hits": hits,
                      "differ": int(differ.sum()),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "agreement": 1.0 - float(differ.sum()) / n_live}
    return n_live, out


def wavefront_phases(scene, cfg, order, card):
    """Phases 5-7 (the wavefront route); returns the two traversal
    kernels' JSON records."""
    import numpy as np
    import torch
    from offline_raytracer_tpu_torch.ops import mega, traverse_cull
    from offline_raytracer_tpu_torch.ops import traverse_packet
    from offline_raytracer_tpu_torch.render import (
        render_block, render_block_stats)

    # ---- phase 5: both kernels vs the plain sweep on every query of a
    # full-size sample, each timed at the route's shapes
    queries = capture_queries(scene, cfg, order)
    log(f"phase 5 queries: {len(queries)} triangle queries of one "
        f"{queries[0][1].shape[0]}-ray sample (per bounce a closest-hit "
        f"and a shadow query)")
    per_query = []
    for k, q in enumerate(queries):
        b, kind = k // 2, ("shadow" if q[4] else "closest")
        n_live, res = compare_query(b, q, cfg.t_min)
        if k == 0 and res["traverse_cull"]["hits"] == 0:
            fail("the sample's bounce-0 closest-hit query hit no triangle")
        per_query.append({"b": b, "kind": kind, "live": n_live, **res})
        c, p = res["traverse_cull"], res["traverse_packet"]
        log(f"  b={b} {kind}: live={n_live} hits={c['hits']} differ "
            f"cull={c['differ']} packet={p['differ']}, every G bitwise; "
            f"cull {c['ms']:.4f} ms (G={c['group']}), packet "
            f"{p['ms']:.4f} ms (G={p['group']}), plain {c['plain_ms']:.1f} "
            f"ms, bound cull {c['bound_ms']:.4f} packet "
            f"{p['bound_ms']:.4f} ms ({c['bound_by']})")
    sums = {k: {f: sum(q[k][f] for q in per_query)
                for f in ("ms", "plain_ms", "bound_ms")}
            for k in ("traverse_cull", "traverse_packet")}
    log(f"phase 5 per sample ({len(queries)} queries): cull "
        f"{sums['traverse_cull']['ms']:.4f} ms, packet "
        f"{sums['traverse_packet']['ms']:.4f} ms, plain "
        f"{sums['traverse_cull']['plain_ms']:.1f} ms; bounds cull "
        f"{sums['traverse_cull']['bound_ms']:.4f} ms, packet "
        f"{sums['traverse_packet']['bound_ms']:.4f} ms [{card}]")

    # ---- phase 6: the wavefront slice through each kernel
    mods = {"cull": traverse_cull, "packet": traverse_packet}
    launches = {}
    for route, mod in mods.items():
        rcfg = cfg.replace(traversal=route, spp=WSPP)
        torch.cuda.synchronize()
        mega.KERNEL_LAUNCHES = 0
        for m in mods.values():
            m.KERNEL_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        acc = torch.zeros((W * H, 3), dtype=torch.float32, device=order.device)
        rays = 0.0
        alives = []
        for s in range(WSPP):         # ray_batch = W*H: one call per sample
            out, alive = render_block_stats(scene, rcfg, order, s, 1)
            acc += out
            alives.append(alive)
        for alive in alives:
            a = alive.cpu().numpy().astype(np.float64)   # exact past 2**24
            rays += W * H + a.sum() + W * H + a[:-1].sum()
        img = (acc / WSPP).cpu().numpy()
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        launches[route] = mod.KERNEL_LAUNCHES
        want = 2 * BOUNCES * WSPP
        others = [m.KERNEL_LAUNCHES for r, m in mods.items() if r != route]
        if mod.KERNEL_LAUNCHES != want or any(others) or mega.KERNEL_LAUNCHES:
            fail(f"{route} route launches {mod.KERNEL_LAUNCHES} (want "
                 f"{want}), other kernels {others}, mega "
                 f"{mega.KERNEL_LAUNCHES}")
        if not np.isfinite(img).all() or not img.mean() > 0:
            fail(f"{route} slice image broken: mean {img.mean()}")
        log(f"phase 6 wavefront slice ({route}): bunny stand-in {W}x{H} "
            f"{WSPP} spp {BOUNCES} bounces in {dt:.3f} s, {rays:.0f} rays, "
            f"{rays / dt / 1e6:.3f} Mrays/s, {mod.KERNEL_LAUNCHES} kernel "
            f"launches ({mod.KERNEL_LAUNCHES // WSPP} per sample), peak "
            f"device memory {peak:.1f} MiB, image mean {img.mean():.5f} "
            f"[{card}]")

    # ---- phase 7: segment vs cull vs packet, bench.py's bounds
    probe = order[::64]
    outs = {m: render_block(scene, cfg.replace(traversal=m), probe, 0, 2)
            .cpu().numpy() for m in ("mega", "cull", "packet")}
    for m in ("cull", "packet"):
        a, b = outs["mega"], outs[m]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2)
        mean_ok = abs(a.mean() - b.mean()) < 2e-3 * max(b.mean(), 1e-3)
        share = float((rel > 1e-2).mean())
        log(f"phase 7 cross-check mega vs {m}: means {a.mean():.6f} "
            f"{b.mean():.6f}, {share:.4%} of pixel channels differ > 1%")
        if not mean_ok or share >= 0.005:
            fail(f"mega vs {m} disagree")

    sources = {"traverse_cull":
               "offline_raytracer_tpu/ops/traverse_cull.py:117",
               "traverse_packet":
                   "offline_raytracer_tpu/ops/traverse_pallas.py:57"}
    return [{
        "name": k, "route": "cuda",
        "source": f"offline_raytracer_tpu_torch/csrc/{k}.cu",
        "replaces": sources[k],
        "launches": launches[k.split("_")[1]],
        "agreement": min(q[k]["agreement"] for q in per_query),
        "max_abs_err": max(q[k]["err"] for q in per_query),
        "ms": sums[k]["ms"], "plain_ms": sums[k]["plain_ms"],
        "bound_ms": sums[k]["bound_ms"],
        "bound_by": per_query[0][k]["bound_by"], "library_ms": None,
        "per": "one sample: the sum over its triangle queries",
        "queries": [{"b": q["b"], "kind": q["kind"], "live": q["live"],
                     "group": q[k]["group"], "ms": q[k]["ms"],
                     "bound_ms": q[k]["bound_ms"]} for q in per_query]}
        for k in ("traverse_cull", "traverse_packet")]


def threefry_bound(nbytes, blocks):
    """(bound_ms, bound_by) of a threefry launch: nbytes moved once at the
    card's bandwidth, or the ALU issue of its threefry blocks."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = blocks * THREEFRY_ALU_OPS / PEAK_ALU_OPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def threefry_phase(cfg, order, card):
    """Phase 3's draws: the threefry kernel's calls of one full-size sample
    of the main path (the per-ray keys, the camera's uniforms, each
    segment's planes) against the plain int64 version on the same inputs,
    bit for bit, each timed beside its bound. Returns the kernels record's
    entry."""
    import torch
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.utils import rng

    R = order.shape[0]
    root = rng.render_key(cfg.seed, order.device)
    smp = torch.zeros_like(order)
    keys = rng.pixel_sample_keys_cuda(root, order, smp)
    draws = [("keys", lambda: rng.pixel_sample_keys_cuda(root, order, smp),
              lambda: rng.pixel_sample_keys_plain(root, order, smp),
              16 + R * (2 * order.element_size() + 16), 2 * R)]
    for tag_lo, n_tags, n in ([(rng.CAMERA_TAG, 1, 4)]
                              + [(b, nf, 8)
                                 for b, nf in mega.segment_plan(cfg)[0]]):
        draws.append((
            "camera planes" if tag_lo == rng.CAMERA_TAG
            else f"segment b={tag_lo} nf={n_tags} planes",
            lambda a=(keys, tag_lo, n_tags, n): rng.uniform_planes_cuda(*a),
            lambda a=(keys, tag_lo, n_tags, n): rng.uniform_planes_plain(*a),
            16 * R + 4 * n_tags * n * R, R * n_tags * ((n + 1) // 2)))
    calls = []
    for name, kernel, plain, nbytes, blocks in draws:
        got, want = kernel(), plain()
        if got.shape != want.shape or not torch.equal(
                got.view(torch.int32 if got.dtype == torch.float32
                         else torch.int64),
                want.view(torch.int32 if want.dtype == torch.float32
                          else torch.int64)):
            fail(f"threefry {name}: the kernel's {tuple(got.shape)} "
                 f"differs from the plain version's {tuple(want.shape)}")
        k_ms, p_ms = time_ms(kernel, 50), time_ms(plain, 3)
        b_ms, b_by = threefry_bound(nbytes, blocks)
        log(f"  threefry {name}: R={R}, bitwise equal to the plain version, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} bytes, {blocks} blocks) [{card}]")
        calls.append({"call": name, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
    sums = {f: sum(c[f] for c in calls) for f in ("ms", "plain_ms",
                                                   "bound_ms")}
    log(f"  threefry draws of a full-size sample ({len(calls)} calls): "
        f"kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.3f} ms, "
        f"bound {sums['bound_ms']:.4f} ms [{card}]")
    return {"name": "threefry_draw", "route": "cuda",
            "source": "offline_raytracer_tpu_torch/csrc/threefry.cu",
            "replaces": None, "max_abs_err": 0.0, **sums,
            "bound_by": max(calls, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None, "calls": calls}


def sweep_bound(lanes, spheres):
    """(bound_ms, bound_by) of one sphere sweep over ``lanes`` lanes: the
    bytes of ``portbench/roofline_wave.hit_bound_ms`` for one query, or
    the lanes' pair tests at the card's FP32 issue rate."""
    from portbench.roofline_wave import hit_bound_ms

    by_bytes = hit_bound_ms(lanes, 1, spheres)
    by_ops = lanes * spheres * SPHERE_TEST_OPS / PEAK_FP32_ISSUE * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def rtiow_scene(dev):
    """(scene, cfg) of ``portbench/configs/rtiow_final.json`` on ``dev``."""
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder
    from portbench.inputs import recipe

    with open(os.path.join(HERE, "portbench", "configs",
                           "rtiow_final.json")) as f:
        c = json.load(f)
    b = recipe.apply(SceneBuilder(), recipe.calls(c["scene"]), c["camera"])
    b.set_sky(**c["sky"])
    cfg = RenderConfig(**c["render"])
    return b.build(cfg.width, cfg.height, device=dev), cfg


def sphere_sweep_phase(dev, card):
    """Phase 12: the sphere sweep kernel against the plain sweep on bounce
    ``SWEEP_BOUNCE``'s closest-hit query of a full-size sample of the final
    scene. Returns the kernels record's entry."""
    import torch
    from offline_raytracer_tpu_torch.ops import intersect
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.render import _paths_fn, tile_pixel_ids
    from offline_raytracer_tpu_torch.utils import rng

    scene, cfg = rtiow_scene(dev)
    cfg = cfg.replace(max_bounces=SWEEP_BOUNCE + 1)
    sph = scene.spheres
    N = sph.radius.shape[0]
    ids = torch.from_numpy(tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, dev), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    seen = []
    original = intersect.sphere_sweep

    def recording(sph, ro, rd, t_min, alive=None):
        if alive is not None:        # a closest-hit query, one a bounce
            if len(seen) == SWEEP_BOUNCE:
                seen.append((ro.clone(), rd.clone(), alive.clone()))
            else:
                seen.append(None)
        return original(sph, ro, rd, t_min, alive)

    intersect.sphere_sweep = recording
    intersect.KERNEL_LAUNCHES = 0
    try:
        with torch.no_grad():
            _paths_fn(scene, cfg)(ro, rd, keys)
    finally:
        intersect.sphere_sweep = original
    torch.cuda.synchronize()
    # one closest-hit query a bounce, each one launch; the scene has no
    # light, so no shadow query
    path_launches = intersect.KERNEL_LAUNCHES
    if path_launches != SWEEP_BOUNCE + 1 or len(seen) != SWEEP_BOUNCE + 1:
        fail(f"sphere sweep: {SWEEP_BOUNCE + 1} bounces launched the kernel "
             f"{path_launches} times over {len(seen)} closest-hit queries, "
             f"want {SWEEP_BOUNCE + 1} of each")
    q_ro, q_rd, alive = seen[SWEEP_BOUNCE]
    R = q_ro.shape[0]
    live = int(alive.sum())
    t_min = cfg.t_min

    def plain():
        return intersect.sphere_ts(sph, q_ro, q_rd, t_min).min(-1)

    def masked():
        return intersect.sphere_sweep_cuda(sph, q_ro, q_rd, t_min, alive)

    def every():
        return intersect.sphere_sweep_cuda(sph, q_ro, q_rd, t_min)

    before = intersect.KERNEL_LAUNCHES
    p_t, p_i = plain()
    m_t, m_i = masked()
    e_t, e_i = every()
    torch.cuda.synchronize()
    if intersect.KERNEL_LAUNCHES != before + 2:
        fail(f"sphere sweep launches {intersect.KERNEL_LAUNCHES - before}, "
             f"want 2")
    p_i = p_i.to(torch.int32)
    if not torch.equal(e_i, p_i):
        fail(f"sphere sweep over every lane: {int((e_i != p_i).sum())} of "
             f"{R} winners differ from the plain sweep's")
    if not torch.equal(m_i[alive], p_i[alive]):
        fail(f"sphere sweep, masked: "
             f"{int((m_i[alive] != p_i[alive]).sum())} of {live} live "
             f"winners differ from the plain sweep's")
    if not (torch.isinf(m_t[~alive]).all() and (m_i[~alive] == 0).all()):
        fail("sphere sweep, masked: a dead lane is not a miss")
    # the distances too, bit for bit: ``closest_hit_bruteforce`` takes a
    # hit from t < inf and weighs it against the other tables by t
    t_differ = int((e_t.view(torch.int32) != p_t.view(torch.int32)).sum())
    m_differ = int((m_t[alive].view(torch.int32)
                    != p_t[alive].view(torch.int32)).sum())
    if t_differ or m_differ:
        fail(f"sphere sweep: distances differ bitwise from the plain "
             f"sweep's on {t_differ} of {R} lanes over every lane and on "
             f"{m_differ} of {live} live lanes masked")
    hits = int(torch.isfinite(p_t[alive]).sum())
    k_ms, e_ms, p_ms = time_ms(masked, 20), time_ms(every, 5), time_ms(plain,
                                                                        2)
    b_ms, b_by = sweep_bound(live, N)
    e_b_ms, e_b_by = sweep_bound(R, N)
    log(f"phase 12 sphere sweep: rtiow_final bounce {SWEEP_BOUNCE}, {R} rays "
        f"x {N} spheres, {live} live ({100.0 * live / R:.3f}%), {hits} of "
        f"them hit; {path_launches} launches over the {SWEEP_BOUNCE + 1} "
        f"bounces; winners and distances bitwise the plain sweep's; "
        f"masked kernel {k_ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}), every "
        f"lane {e_ms:.4f} ms (bound {e_b_ms:.4f} ms, {e_b_by}), plain "
        f"{p_ms:.3f} ms [{card}]")
    return {"name": "sphere_sweep", "route": "cuda",
            "source": "offline_raytracer_tpu_torch/csrc/sphere_sweep.cu",
            "replaces": None, "max_abs_err": 0.0, "launches": path_launches,
            "t_differ": t_differ, "lanes": R, "live": live, "spheres": N,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "every_lane_ms": e_ms,
            "every_lane_bound_ms": e_b_ms, "library_ms": None}


def shade_bound(lanes, live, in_place):
    """(bound_ms, bound_by) of one shading launch over ``lanes`` lanes of
    which ``live`` live on entry: the bytes above at the card's bandwidth,
    or ``SHADE_FLOP`` float32 operations a live lane at its peak."""
    dead = SHADE_DEAD_BYTES if in_place else SHADE_DEAD_COPY_BYTES
    return bound(live * SHADE_LIVE_BYTES + (lanes - live) * dead,
                 live * SHADE_FLOP)


def time_each_ms(prepare, fn, reps):
    """Mean CUDA-event ms of ``fn(prepare())``, ``prepare`` untimed."""
    import torch

    fn(prepare())
    total = 0.0
    for _ in range(reps):
        arg = prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def wave_shade_phase(dev, card):
    """Phase 13: the shading kernel against the eager body on bounces
    ``SHADE_BOUNCES`` of a full-size sample of the final scene. Returns the
    kernels record's entry."""
    import torch
    from offline_raytracer_tpu_torch import integrator
    from offline_raytracer_tpu_torch.ops import wave_shade
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.render import _paths_fn, tile_pixel_ids
    from offline_raytracer_tpu_torch.utils import rng

    scene, cfg = rtiow_scene(dev)
    cfg = cfg.replace(max_bounces=SWEEP_BOUNCE + 1)
    ids = torch.from_numpy(tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, dev), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    seen = {}
    original = wave_shade.shade_cuda

    def recording(tables, cfg_, b, hit, state, u, in_place=False):
        if b in SHADE_BOUNCES:
            seen[b] = (hit, tuple(x.clone() for x in state), in_place)
        return original(tables, cfg_, b, hit, state, u, in_place)

    wave_shade.shade_cuda = recording
    wave_shade.KERNEL_LAUNCHES = 0
    try:
        with torch.no_grad():
            _paths_fn(scene, cfg)(ro, rd, keys)
    finally:
        wave_shade.shade_cuda = original
    torch.cuda.synchronize()
    path_launches = wave_shade.KERNEL_LAUNCHES
    if path_launches != cfg.max_bounces or sorted(seen) != list(
            SHADE_BOUNCES):
        fail(f"wave shade: {cfg.max_bounces} bounces launched the kernel "
             f"{path_launches} times, bounces {sorted(seen)} captured")
    tables = wave_shade.shade_tables(scene.materials, scene.sky)
    planes = ("origin", "direction", "throughput", "radiance", "alive",
              "prev_pdf")
    rows = []
    with torch.no_grad():
        for b in SHADE_BOUNCES:
            hit, state_in, in_place = seen[b]
            state = integrator.PathState(*state_in, keys=keys)

            def eager():
                u8 = rng.bounce_uniforms(keys, b, 8)
                return integrator.shade_bounce(
                    scene, cfg, state, b, hit,
                    integrator.surface_record(scene, cfg, u8, hit.mat))

            def kernel(copies=None):
                u = rng.uniform_planes(keys, b, 1, 8)
                return wave_shade.shade_cuda(
                    tables, cfg, b, hit, state_in if copies is None
                    else copies, u, in_place=copies is not None)

            def fresh():
                return tuple(x.clone() for x in state_in)

            want = eager()
            before = wave_shade.KERNEL_LAUNCHES
            outs = {"new planes": kernel(), "in place": kernel(fresh())}
            torch.cuda.synchronize()
            if wave_shade.KERNEL_LAUNCHES != before + 2:
                fail(f"wave shade launches "
                     f"{wave_shade.KERNEL_LAUNCHES - before}, want 2")
            for how, got in outs.items():
                for name, g in zip(planes, got):
                    w = getattr(want, name).contiguous()
                    if name == "alive":
                        differ = int((g != w).sum())
                    else:
                        differ = int((g.view(torch.int32)
                                      != w.view(torch.int32)).sum())
                    if differ:
                        fail(f"wave shade bounce {b}, {how}: {name} differs "
                             f"bitwise from the eager body's on {differ} "
                             f"values")
            R = ro.shape[0]
            live = int(state.alive.sum())
            k_ms = time_each_ms(fresh, kernel, 20) if in_place else time_ms(
                kernel, 20)
            p_ms = time_ms(eager, 3)
            b_ms, b_by = shade_bound(R, live, in_place)
            log(f"phase 13 wave shade: rtiow_final bounce {b}, {R} lanes, "
                f"{live} live ({100.0 * live / R:.3f}%), "
                f"{'in place' if in_place else 'new planes'}; outputs "
                f"bitwise the eager body's; kernel {k_ms:.4f} ms (bound "
                f"{b_ms:.4f} ms, {b_by}), eager {p_ms:.3f} ms [{card}]")
            rows.append({"bounce": b, "live": live, "in_place": in_place,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by})
    last = rows[-1]
    return {"name": "wave_shade", "route": "cuda",
            "source": "offline_raytracer_tpu_torch/csrc/wave_shade.cu",
            "replaces": None, "max_abs_err": 0.0, "launches": path_launches,
            "lanes": ro.shape[0], "live": last["live"], "ms": last["ms"],
            "plain_ms": last["plain_ms"], "bound_ms": last["bound_ms"],
            "bound_by": last["bound_by"], "library_ms": None,
            "bounces": rows}


def take_counts():
    """Launches of the (mega, cull, packet) kernels since the last call;
    sets the three counts to 0."""
    from offline_raytracer_tpu_torch.ops import (
        mega, traverse_cull, traverse_packet)

    mods = (mega, traverse_cull, traverse_packet)
    counts = tuple(m.KERNEL_LAUNCHES for m in mods)
    for m in mods:
        m.KERNEL_LAUNCHES = 0
    return counts


def grad_step(scene, cfg, gids, mode):
    """One gradient step of bench.py's loss: (loss, (d albedo, d v0))."""
    import dataclasses

    import torch
    from offline_raytracer_tpu_torch.render import render_block

    kd = scene.materials.diffuse.clone().requires_grad_(True)
    v0 = scene.triangles.v0.clone().requires_grad_(True)
    sc = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, diffuse=kd),
        triangles=dataclasses.replace(scene.triangles, v0=v0))
    loss = render_block(sc, cfg.replace(grad_mode=mode), gids, 0, 1).mean()
    return loss, torch.autograd.grad(loss, (kd, v0))


def gradient_phases(scene, cfg, order, card):
    """Phases 8-9 (the gradient path); returns the segment launches they
    made."""
    import dataclasses

    import numpy as np
    import torch
    from offline_raytracer_tpu_torch import diff
    from offline_raytracer_tpu_torch.integrator import trace_paths
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.ops.camera import generate_rays
    from offline_raytracer_tpu_torch.render import (
        render_block, render_block_stats)
    from offline_raytracer_tpu_torch.utils import rng

    gcfg = cfg.replace(spp=1, grad_mode="replay-value")
    gids = order[:GRAD_PIXELS]
    per_step = len(mega.segment_plan(gcfg)[0])
    nee = gcfg.enable_nee and scene.n_lights > 0
    torch.cuda.synchronize()
    take_counts()

    # ---- phase 8: the gradient step
    _, alive = render_block_stats(scene, gcfg, gids, 0, 1)
    a = alive.cpu().numpy().astype(np.float64)
    rays = GRAD_PIXELS + a.sum() + (GRAD_PIXELS + a[:-1].sum() if nee else 0)
    grad_step(scene, gcfg, gids, "replay-value")          # untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = take_counts()[0]
    draws_before = rng.KERNEL_LAUNCHES
    t0 = time.time()
    for _ in range(GRAD_STEPS):
        loss, grads = grad_step(scene, gcfg, gids, "replay-value")
    torch.cuda.synchronize()
    dt = (time.time() - t0) / GRAD_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**20
    step_launches, cull, packet = take_counts()
    total += step_launches
    if step_launches != per_step * GRAD_STEPS or cull or packet:
        fail(f"gradient steps launched {step_launches} segments (want "
             f"{per_step * GRAD_STEPS}), cull {cull}, packet {packet}")
    step_draws = (rng.KERNEL_LAUNCHES - draws_before) // GRAD_STEPS
    if step_draws < per_step + 2:
        fail(f"gradient steps launched {step_draws} threefry kernels per "
             f"step, want at least {per_step + 2}")
    for name, g in zip(("albedo", "v0"), grads):
        if not bool(torch.isfinite(g).all()) or not g.abs().max() > 0:
            fail(f"d loss / d {name} is not finite and nonzero")
    mrays = rays / dt / 1e6
    log(f"phase 8 gradient step: bunny stand-in {GRAD_PIXELS} pixels 1 spp "
        f"{gcfg.max_bounces} bounces, replay-value, {dt * 1e3:.3f} ms per "
        f"step ({GRAD_STEPS} steps, one sync), {rays:.0f} rays per step, "
        f"{mrays:.3f} fwd+bwd Mrays/s, loss {loss.item():.6f}, "
        f"{step_launches // GRAD_STEPS} segment and {step_draws} threefry "
        f"launches per step, 0 cull or packet, peak device memory {peak:.1f} MiB, |d albedo| max "
        f"{grads[0].abs().max().item():.4e}, |d v0| max "
        f"{grads[1].abs().max().item():.4e} [{card}]")
    _, k_grads = grad_step(scene, gcfg, gids, "kernel-value")
    for name, r, k in zip(("albedo", "v0"), grads, k_grads):
        r, k = r.cpu().numpy(), k.cpu().numpy()
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(k, r, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f"kernel-value d {name}")
        log(f"  kernel-value vs replay-value d {name}: max abs diff "
            f"{np.abs(k - r).max():.3e} (max |g| {scale:.3e})")

    # the step's rays: kernel radiance vs the replay's, records vs plain
    keys = rng.pixel_sample_keys(rng.render_key(gcfg.seed, gids.device),
                                 gids, torch.zeros_like(gids))
    ro, rd = generate_rays(scene.camera, gcfg, gids, keys)
    k_rad, ids, vis, k_alive = mega.render_paths_mega(
        scene, gcfg, ro, rd, keys, collect_records=True)
    with torch.no_grad():
        r_rad = trace_paths(scene, gcfg, None, ro, rd, keys,
                            replay=(ids, vis))
    ka, ra = k_rad.cpu().numpy(), r_rad.cpu().numpy()
    d = np.abs(ka - ra)
    log(f"  kernel vs replay radiance on {GRAD_PIXELS} rays: max abs "
        f"{d.max():.3e}, {(d > 1e-3).mean():.4%} of channels > 1e-3, mean "
        f"diff {abs(ka.mean() - ra.mean()):.3e}")
    if d.max() >= 0.3 or (d > 1e-3).mean() >= 0.002 or abs(
            ka.mean() - ra.mean()) >= 2e-4:
        fail("kernel and replay radiance disagree")
    original = mega.mega_segment
    mega.mega_segment = mega.mega_segment_plain
    try:
        _, p_ids, p_vis, _ = mega.render_paths_mega(
            scene, gcfg, ro, rd, keys, collect_records=True)
    finally:
        mega.mega_segment = original
    live = torch.cat([torch.ones_like(k_alive[:1]), k_alive[:-1]]) > 0.5
    differ = ((ids != p_ids) | (vis != p_vis)) & live
    share = differ.sum().item() / max(live.sum().item(), 1)
    log(f"  records vs the plain version: {differ.sum().item()} of "
        f"{live.sum().item()} live records differ ({share:.4%})")
    if share > RECORD_BUDGET:
        fail("the step's records disagree with the plain version's")

    # ---- phase 9: inverse rendering
    target = render_block(scene, gcfg, gids, 1000, 8)
    m = int(scene.triangles.mat[0])             # the mesh's material
    wrong = scene.materials.diffuse.clone()
    wrong[m] = torch.tensor(WRONG_ALBEDO, device=wrong.device)
    scene0 = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=wrong))
    icfg = gcfg.replace(spp=INV_SPP)
    total += take_counts()[0]
    t0 = time.time()
    params, losses = diff.optimize(scene0, icfg, target, gids,
                                   diff.material_params(scene0),
                                   steps=INV_STEPS, lr=0.1)
    inv_s = time.time() - t0
    inv_launches, cull, packet = take_counts()
    total += inv_launches
    if inv_launches != per_step * INV_SPP * INV_STEPS or cull or packet:
        fail(f"inverse rendering launched {inv_launches} segments (want "
             f"{per_step * INV_SPP * INV_STEPS}), cull {cull}, packet "
             f"{packet}")
    # the recovered parameters on the first step's samples: the same
    # noise as losses[0], so the two differ by the parameters alone
    with torch.no_grad():
        final = diff.make_loss_fn(scene0, icfg, target, gids)(params).item()
    truth = scene.materials.diffuse[m].cpu().numpy()
    rec = params["diffuse"][m].cpu().numpy()
    err0 = float(np.abs(np.array(WRONG_ALBEDO) - truth).mean())
    err = float(np.abs(rec - truth).mean())
    log(f"phase 9 inverse rendering: {INV_STEPS} Adam steps in "
        f"{inv_s:.3f} s, losses {' '.join(f'{x:.6f}' for x in losses)}, "
        f"the result on step 0's samples {final:.6f}; mesh albedo "
        f"{np.round(rec, 4).tolist()} (truth {truth.tolist()}), mean abs "
        f"error {err0:.4f} -> {err:.4f}, {inv_launches} segment launches "
        f"[{card}]")
    if not final < losses[0] or not err < err0:
        fail("inverse rendering did not improve the loss and the albedo")
    return total + take_counts()[0]


def run_cli(argv):
    """cli.main(argv) in this process, its output captured: (its JSON
    line, its stdout, its stderr). A failure raises."""
    import contextlib
    import io

    from offline_raytracer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli.main returned {rc}: {err.getvalue()[-2000:]}")
    return (json.loads(out.getvalue().strip().splitlines()[-1]),
            out.getvalue(), err.getvalue())


def cli_phase(dev, card):
    """Phase 10 (the command line); returns the segment launches of its
    render."""
    import tempfile

    import numpy as np
    import torch
    from offline_raytracer_tpu_torch import cli
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.render import _mega_active
    from offline_raytracer_tpu_torch.scene.scn import load_scene
    from offline_raytracer_tpu_torch.utils import checkpoint as ckpt
    from offline_raytracer_tpu_torch.utils import hdr
    from torch_port_cases import procedural_mesh, write_scene_files

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        v, f = procedural_mesh(N_TRIS)
        scn = write_scene_files(tmp, v, f)
        t_write = time.time() - t0
        t0 = time.time()
        scene, size = load_scene(scn, device=dev)
        t_load = time.time() - t0
        base = ["--scene", scn, "--max-bounces", str(BOUNCES), "--no-dof",
                "--ray-batch", str(W * H)]
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            base + ["--spp", str(CLI_SPP)]), *size)
        if size != (W, H) or not mega.mega_ok(scene, cfg) or not _mega_active(
                scene, cfg):
            fail(f"the .scn loads at {size}, not on the segment route")
        per_sample = len(mega.segment_plan(cfg)[0])
        log(f"phase 10 scene files: {N_TRIS}-triangle .ply, .obj and .scn "
            f"written in {t_write:.2f} s; load_scene (parse, transform, "
            f"pure-Python LBVH) in {t_load:.2f} s: "
            f"{scene.triangles.mat.shape[0]} triangles, "
            f"{scene.tri_bvh.m_occ} leaves, {scene.spheres.radius.shape[0]} "
            f"spheres, {scene.boxes.mat.shape[0]} box, "
            f"{scene.cylinders.radius.shape[0]} cylinder, {scene.n_lights} "
            f"light; segment route")

        images = []                          # every image main writes
        write_hdr = hdr.write_hdr

        def recording(path, img):
            images.append(np.array(img))
            write_hdr(path, img)

        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        every = ["--checkpoint-every", str(CLI_EVERY)]
        hdr.write_hdr = recording
        try:
            # the render, counted from 0 just before to just after
            torch.cuda.synchronize()
            take_counts()
            line, _, err = run_cli(base + [
                "--spp", str(CLI_SPP), "--meter", "--out", path("r.hdr"),
                "--png", path("r.png")])
            launches, cull, packet = take_counts()
            # the resume surgery
            t0 = time.time()
            run_cli(base + ["--spp", str(CLI_SPP), "--checkpoint",
                            path("a.npz"), "--out", path("a.hdr")] + every)
            run_cli(base + ["--spp", str(CLI_EVERY), "--checkpoint",
                            path("b.npz"), "--out", path("h.hdr")] + every)
            state = ckpt.load_accum(path("b.npz"), cfg.replace(spp=CLI_EVERY))
            if state is None or state[1] != CLI_EVERY:
                fail("the 4-spp run left no checkpoint at spp 4")
            ckpt.save_accum(path("b.npz"), state[0], CLI_EVERY, cfg)
            _, out, _ = run_cli(base + [
                "--spp", str(CLI_SPP), "--checkpoint", path("b.npz"),
                "--out", path("b.hdr"), "--progress"] + every)
            t_resume = time.time() - t0
        finally:
            hdr.write_hdr = write_hdr

        if launches != per_sample * CLI_SPP or cull or packet:
            fail(f"the command line launched {launches} segments (want "
                 f"{per_sample * CLI_SPP}), cull {cull}, packet {packet}")
        meter = [json.loads(x) for x in err.splitlines()
                 if x.startswith('{"event": "render_meter"')]
        img = images[0]
        if (len(meter) != 1 or img.shape != (H, W, 3)
                or not np.isfinite(img).all() or not img.mean() > 0):
            fail(f"the command line's render is broken: {meter}, "
                 f"{img.shape}, mean {img.mean()}")
        back = hdr.read_hdr(path("r.hdr"))
        if not np.array_equal(back, hdr.rgbe_to_float(hdr.float_to_rgbe(img))):
            fail("the .hdr read back differs from the image's RGBE rounding")
        with open(path("r.png"), "rb") as fh:
            if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                fail("the .png is not a PNG")
        straight = ckpt.load_accum(path("a.npz"), cfg)
        resumed = ckpt.load_accum(path("b.npz"), cfg)
        if ("resumed" not in out or straight[1] != CLI_SPP
                or resumed[1] != CLI_SPP):
            fail("the resumed run did not resume to spp 8")
        differ = int((straight[0].view(np.int32)
                      != resumed[0].view(np.int32)).sum())
        with open(path("a.hdr"), "rb") as fa, open(path("b.hdr"), "rb") as fb:
            same_file = fa.read() == fb.read()
        if differ or not same_file or not np.array_equal(images[1],
                                                         images[3]):
            fail(f"the resumed render differs from the uninterrupted one in "
                 f"{differ} of {straight[0].size} sums")
        # the tile-order render (1 spp per launch) vs the natural-order
        # resumable one (4 per launch): the same rays, summed in another
        # order
        rel = float((np.abs(img - images[1])
                     / np.maximum(np.abs(images[1]), 1e-6)).max())
        np.testing.assert_allclose(img, images[1], rtol=1e-4, atol=1e-6)
        m = meter[0]
        log(f"phase 10 command line: cli.main --scene (.scn with .ply and "
            f".obj meshes) {W}x{H} {CLI_SPP} spp {BOUNCES} bounces, render "
            f"{line['seconds']:.3f} s (its scene load apart), meter "
            f"{m['mrays_per_s']} Mrays/s ({m['rays']} rays in "
            f"{m['seconds']} s over {CLI_SPP} launches), {launches} segment "
            f"launches ({per_sample} per sample), 0 cull or packet; .hdr "
            f"read back = the image's RGBE rounding; image mean "
            f"{img.mean():.5f} [{card}]")
        log(f"phase 10 resume: uninterrupted, 4-spp, resumed --checkpoint "
            f"runs in {t_resume:.3f} s (3 scene loads included); resumed "
            f"sums bitwise equal to the uninterrupted ({differ} of "
            f"{straight[0].size} differ), .hdr files byte-equal; vs the "
            f"tile-order render max rel diff {rel:.3e}")
    return launches


def grad_params(sc):
    """The gradient step's parameters: the albedo and the mesh's v0."""
    return {"diffuse": sc.materials.diffuse, "v0": sc.triangles.v0}


def set_grad_params(sc, p):
    import dataclasses

    return dataclasses.replace(
        sc, materials=dataclasses.replace(sc.materials, diffuse=p["diffuse"]),
        triangles=dataclasses.replace(sc.triangles, v0=p["v0"]))


def table_bytes(tables):
    """Device bytes of a traversal table set (ops/traverse.TriTables)."""
    return sum(x.numel() * x.element_size() for x in (
        tables.tri, tables.tri_lm, tables.sub, tables.nodes,
        tables.leaf_bounds, tables.tri_index))


def gloo_rank(group):
    """Phase 11b-c on one rank of the gloo group (run by run_ranks): the
    sharded render, the sharded gradient step, the ring render and the ring
    probe, each counted from 0 just before to just after and timed."""
    import torch
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.parallel import ring, shard
    from offline_raytracer_tpu_torch.render import tile_pixel_ids

    dev = group.device
    scene = bunny_stand_in(dev)
    order = torch.from_numpy(tile_pixel_ids(W, H)).to(dev)
    ids = torch.arange(W * H, dtype=torch.int32, device=dev)
    out = {}

    def counted(name, fn):
        torch.cuda.synchronize(dev)
        take_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize(dev)
        out[name + "_s"] = time.time() - t0
        out[name + "_launches"] = take_counts()
        return res

    cfg = RenderConfig(width=W, height=H, spp=PAR_SPP, max_bounces=BOUNCES,
                       enable_dof=False)
    gcfg = cfg.replace(spp=1, grad_mode="replay-value")
    # this fresh process's first render and gradient step, on 4,096
    # pixels and without collectives, so the timed ones below are warm
    alone = shard.RankGroup(0, 1, dev)
    shard.render_block_sharded(scene, gcfg, alone, ids[:4096])
    shard.grad_step_sharded(scene, gcfg, alone, ids[:4096],
                            torch.zeros((4096, 3), device=dev), grad_params,
                            set_grad_params)
    out["image"] = counted("sharded", lambda: shard.render_block_sharded(
        scene, cfg, group, ids)).cpu().numpy()
    gids = order[:GRAD_PIXELS]
    loss, grads = counted("grad", lambda: shard.grad_step_sharded(
        scene, gcfg, group, gids, torch.zeros((GRAD_PIXELS, 3), device=dev),
        grad_params, set_grad_params))
    out["loss"] = loss.item()
    out["grads"] = {k: g.cpu().numpy() for k, g in grads.items()}

    rcfg = cfg.replace(spp=RING_SPP, traversal="auto")
    shards = ring.prepare_ring_shards(scene, group)
    out["bvh_bytes"] = table_bytes(shards)
    out["ring"] = counted("ring", lambda: ring.render_block_ring(
        scene, rcfg, group, ids, shards=shards)).cpu().numpy()
    out["probe"] = counted("probe", lambda: ring.render_block_ring(
        scene, rcfg.replace(traversal="packet", spp=2), group,
        order[::64], shards=shards)).cpu().numpy()
    return out


def parallel_phase(scene, order, card):
    """Phase 11 (``parallel/``); returns the kernels' launch counts on the
    sharded and ring paths."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.ops.traverse import tri_tables
    from offline_raytracer_tpu_torch.parallel import shard
    from offline_raytracer_tpu_torch.render import render_block

    dev = scene.device
    cfg = RenderConfig(width=W, height=H, spp=PAR_SPP, max_bounces=BOUNCES,
                       enable_dof=False)
    per_sample = len(mega.segment_plan(cfg)[0])
    ids = torch.arange(W * H, dtype=torch.int32, device=dev)

    def differ(a, b):
        return int((a.view(np.int32) != b.view(np.int32)).sum())

    # ---- 11a: NCCL, one rank, in this process
    t0 = time.time()
    shard.init_process_group(
        num_processes=1, process_id=0, device="cuda", backend="nccl",
        init_method=f"tcp://127.0.0.1:{shard.free_port()}", timeout_s=300)
    try:
        group = shard.make_group("cuda")
        torch.cuda.synchronize()
        take_counts()
        t1 = time.time()
        img = shard.render_image_sharded(scene, cfg, group)
        torch.cuda.synchronize()
        t_render = time.time() - t1
        nccl_launches = take_counts()
        backend = group.backend
    finally:
        dist.destroy_process_group()
    t_a = time.time() - t0
    t0 = time.time()
    single = render_block(scene, cfg, ids, 0, PAR_SPP).cpu().numpy()
    t_ref = time.time() - t0
    single = single.reshape(H, W, 3)[::-1]
    n_differ = differ(img, single)
    log(f"phase 11a sharded render, backend {backend}, 1 rank on {dev}: "
        f"bunny stand-in {W}x{H} {PAR_SPP} spp {BOUNCES} bounces, render "
        f"{t_render:.3f} s ({t_a:.3f} s with the group's set-up; the "
        f"single-process render of the same pixels {t_ref:.3f} s), "
        f"{nccl_launches[0]} segment launches ({per_sample} per sample), "
        f"{nccl_launches[1]} cull, {nccl_launches[2]} packet; {n_differ} of "
        f"{img.size} values differ from the single-process render of the "
        f"same pixels [{card}]")
    if nccl_launches != (per_sample * PAR_SPP, 0, 0):
        fail(f"11a: launches (segment, cull, packet) {nccl_launches}, want "
             f"({per_sample * PAR_SPP}, 0, 0)")
    np.testing.assert_allclose(img, single, rtol=1e-5, atol=1e-6)

    # ---- 11b-c: two gloo ranks on the one card (NCCL takes one rank per
    # card), spawned by parallel/shard.run_ranks
    t0 = time.time()
    ranks = shard.run_ranks(gloo_rank, 2, device="cuda", backend="gloo",
                            timeout_s=300, deadline_s=600)
    t_spawn = time.time() - t0
    for r, o in enumerate(ranks):
        if o["sharded_launches"] != (per_sample * PAR_SPP, 0, 0):
            fail(f"11b rank {r}: sharded launches {o['sharded_launches']}")
        if o["grad_launches"] != (per_sample, 0, 0):
            fail(f"11b rank {r}: gradient step launches {o['grad_launches']}")
    flat = ranks[0]["image"].reshape(H, W, 3)[::-1]
    n_differ = differ(flat, img)
    np.testing.assert_allclose(flat, img, rtol=1e-5, atol=1e-6)
    if differ(ranks[1]["image"], ranks[0]["image"]):
        fail("11b: the ranks hold different images")
    log(f"phase 11b sharded render, backend gloo, 2 ranks on {dev}: "
        f"{PAR_SPP} spp, per rank {ranks[0]['sharded_s']:.3f} / "
        f"{ranks[1]['sharded_s']:.3f} s, segment launches "
        f"{ranks[0]['sharded_launches'][0]} / "
        f"{ranks[1]['sharded_launches'][0]} per rank (the whole run "
        f"{t_spawn:.3f} s with 11b-c, the processes' start and a warm-up); "
        f"{n_differ} "
        f"of {img.size} values differ from 11a's image [{card}]")

    gcfg = cfg.replace(spp=1, grad_mode="replay-value")
    gids = order[:GRAD_PIXELS]
    t0 = time.time()
    loss, grads = shard.grad_step_sharded(
        scene, gcfg, shard.make_group("cuda"), gids,
        torch.zeros((GRAD_PIXELS, 3), device=dev), grad_params,
        set_grad_params)
    torch.cuda.synchronize()
    t_single = time.time() - t0
    worst = []
    for k, g in grads.items():
        g = g.cpu().numpy()
        for o in ranks:
            got = o["grads"][k]
            if not np.isfinite(got).all() or not np.abs(got).max() > 0:
                fail(f"11b: d loss / d {k} is not finite and nonzero")
            np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-7,
                                       err_msg=f"11b d {k}")
        worst.append(f"d {k} max abs diff "
                     f"{np.abs(ranks[0]['grads'][k] - g).max():.3e} "
                     f"(max |g| {np.abs(g).max():.3e})")
    np.testing.assert_allclose(ranks[0]["loss"], loss.item(), rtol=1e-4)
    log(f"phase 11b sharded gradient step, backend gloo, 2 ranks: "
        f"{GRAD_PIXELS} pixels 1 spp replay-value, loss "
        f"{ranks[0]['loss']:.6f} (single process {loss.item():.6f}), "
        f"{', '.join(worst)}; per rank {ranks[0]['grad_s']:.3f} / "
        f"{ranks[1]['grad_s']:.3f} s and {ranks[0]['grad_launches'][0]} / "
        f"{ranks[1]['grad_launches'][0]} segment launches, single process "
        f"{t_single:.3f} s [{card}]")

    # ---- 11c: the ring, the stand-in split into 2 Morton shards
    want_cull = 2 * 2 * BOUNCES * RING_SPP
    want_packet = 2 * 2 * BOUNCES * 2
    for r, o in enumerate(ranks):
        if o["ring_launches"] != (0, want_cull, 0):
            fail(f"11c rank {r}: ring launches (segment, cull, packet) "
                 f"{o['ring_launches']}, want (0, {want_cull}, 0)")
        if o["probe_launches"] != (0, 0, want_packet):
            fail(f"11c rank {r}: probe launches {o['probe_launches']}, want "
                 f"(0, 0, {want_packet})")
    rcfg = cfg.replace(spp=RING_SPP)
    t0 = time.time()
    rep = render_block(scene, rcfg.replace(traversal="cull"), ids, 0,
                       RING_SPP).cpu().numpy()
    torch.cuda.synchronize()
    t_rep = time.time() - t0
    got = ranks[0]["ring"]
    bad = ~np.isclose(got, rep, rtol=1e-4, atol=1e-5)
    log(f"phase 11c ring, backend gloo, 2 ranks on {dev}: {W}x{H} "
        f"{RING_SPP} spp {BOUNCES} bounces, traversal auto (cull), per rank "
        f"{ranks[0]['ring_s']:.3f} / {ranks[1]['ring_s']:.3f} s "
        f"({ranks[0]['ring_s'] / want_cull * 1e3:.3f} ms per ring step), "
        f"cull launches {ranks[0]['ring_launches'][1]} / "
        f"{ranks[1]['ring_launches'][1]} per rank, 0 segment or packet; "
        f"replicated cull render {t_rep:.3f} s; {int(bad.sum())} of "
        f"{got.size} values outside rtol 1e-4 / atol 1e-5, "
        f"{differ(got, rep)} differ at all; image mean {got.mean():.5f} "
        f"[{card}]")
    np.testing.assert_allclose(got, rep, rtol=1e-4, atol=1e-5)
    rep_bytes = table_bytes(tri_tables(scene.tri_bvh))
    log(f"  BVH tables on the card: rank 0 {ranks[0]['bvh_bytes']} B, rank 1 "
        f"{ranks[1]['bvh_bytes']} B, replicated {rep_bytes} B (ratio "
        f"{ranks[0]['bvh_bytes'] / rep_bytes:.3f}) [{card}]")
    probe = render_block(scene, rcfg.replace(traversal="packet", spp=2),
                         order[::64], 0, 2).cpu().numpy()
    got = ranks[0]["probe"]
    log(f"phase 11c ring probe: {got.shape[0]} pixels 2 spp, traversal "
        f"packet, per rank {ranks[0]['probe_s']:.3f} / "
        f"{ranks[1]['probe_s']:.3f} s, packet launches "
        f"{ranks[0]['probe_launches'][2]} / {ranks[1]['probe_launches'][2]}; "
        f"{int((~np.isclose(got, probe, rtol=1e-4, atol=1e-5)).sum())} of "
        f"{got.size} values outside the bounds vs the replicated packet route "
        f"[{card}]")
    np.testing.assert_allclose(got, probe, rtol=1e-4, atol=1e-5)
    return {"sharded": {"nccl_1_rank": nccl_launches[0],
                        "gloo_2_ranks": [o["sharded_launches"][0]
                                         for o in ranks],
                        "grad_step": [o["grad_launches"][0] for o in ranks]},
            "cull": [o["ring_launches"][1] for o in ranks],
            "packet": [o["probe_launches"][2] for o in ranks]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.models.scenes import analytic
    from offline_raytracer_tpu_torch.ops import _kernels, light_sample, mega
    from offline_raytracer_tpu_torch.render import (
        render_block_stats, render_image, tile_pixel_ids)
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder
    from offline_raytracer_tpu_torch.utils import rng
    from torch_port_cases import assert_close, shaped_recipe

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 1 card: {kind}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    # ---- phase 2: build the kernels from this checkout, one nvcc each
    t0 = time.time()
    for name, info in _kernels.build_all(KERNELS).items():
        log(f"phase 2 build: {name}.cu -> "
            f"{os.path.relpath(info['path'], HERE)} in "
            f"{info['seconds']:.2f} s (cached={info['cached']}); "
            + " | ".join(ptxas_summary(info["log"])))
    log(f"  all builds done in {time.time() - t0:.2f} s")

    # ---- phase 3: kernel vs plain version on the main path's inputs
    t0 = time.time()
    scene = bunny_stand_in(dev)
    log(f"phase 3 scene: bunny stand-in {scene.triangles.mat.shape[0]} "
        f"triangles, {scene.tri_bvh.m_occ} leaves, built in "
        f"{time.time() - t0:.2f} s")
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
                       enable_dof=False, ray_batch=W * H)
    order = torch.from_numpy(tile_pixel_ids(W, H)).to(dev)
    segs = capture_segments(scene, cfg, order[::order.shape[0] // PROBE])
    results = [compare_segment("bunny bounce-0 segment", segs[0]),
               compare_segment("bunny fused tail", segs[-1])]
    if results[0]["tri_hits"] == 0:
        fail("the bunny probe's bounce-0 segment hit no triangle")
    shaped = shaped_recipe(SceneBuilder).build(64, 64, device=dev)
    scfg = RenderConfig(width=64, height=64, spp=1, max_bounces=4,
                        enable_dof=False)
    for i, s in enumerate(capture_segments(
            shaped, scfg, torch.arange(4096, device=dev))):
        compare_segment(f"shaped segment {i}", s)
    golden = np.load(os.path.join(HERE, "tests", "golden",
                                  "analytic_24x24_16spp.npy"))
    img = render_image(analytic(24, 24, device=dev), RenderConfig(
        width=24, height=24, spp=16, seed=7, max_bounces=5, enable_dof=False))
    assert_close(golden.reshape(-1, 3), img.reshape(-1, 3))
    log(f"  analytic 24x24 16 spp vs tests/golden: max abs diff "
        f"{np.abs(golden - img).max():.3e}")
    segments, lights = [], []
    for s in capture_segments(scene, cfg, order):
        state, seg = s[0], s[4]
        g = mega.group_size(seg, state.shape[1])
        ms = group_times(s, sorted({1, g}))
        b_ms, b_by = segment_bound(s, mega.mega_segment_cuda(*s)[1])
        live = int((state[10] > 0.5).sum())
        log(f"  full-size segment b={seg.b_start} nf={seg.n_fused}: {live} "
            f"live of {state.shape[1]}, G={g} {ms[g]:.4f} ms, G=1 "
            f"{ms[1]:.4f} ms, outputs bitwise equal, bound {b_ms:.4f} ms "
            f"({b_by}) [{card}]")
        segments.append({"b": seg.b_start, "nf": seg.n_fused, "live": live,
                         "group": g, "ms": ms[g], "ms_g1": ms[1],
                         "bound_ms": b_ms, "bound_by": b_by})
        if seg.do_nee:
            lights.append(compare_light_planes(scene, s))
            log(f"  its light-sample planes: kernel, main path and plain "
                f"twin bitwise equal; kernel {lights[-1][0]:.4f} ms, plain "
                f"{lights[-1][1]:.4f} ms, bound {lights[-1][2]:.4f} ms "
                f"(bytes) [{card}]")
    log(f"  full-size sample: segment kernels "
        f"{sum(x['ms'] for x in segments):.4f} ms at the rule's G, "
        f"{sum(x['ms_g1'] for x in segments):.4f} ms at G=1 [{card}]")
    if not lights:
        fail("the bunny stand-in's sample ran no NEE: no light planes")
    draws = threefry_phase(cfg, order, card)

    # ---- phase 4: the slice through the kernel
    per_sample = len(mega.segment_plan(cfg)[0])
    nee = cfg.enable_nee and scene.n_lights > 0
    torch.cuda.synchronize()
    mega.KERNEL_LAUNCHES = 0
    light_sample.KERNEL_LAUNCHES = 0
    rng.KERNEL_LAUNCHES = 0
    t0 = time.time()
    tables = mega.prepare_tables(scene, cfg)
    acc = torch.zeros((W * H, 3), dtype=torch.float32, device=dev)
    launches_alive = []
    for s in range(SPP):         # ray_batch = W*H: one launch per sample
        out, alive = render_block_stats(scene, cfg, order, s, 1, tables)
        acc += out
        launches_alive.append((W * H, alive))
    rays = 0.0
    for n_paths, alive in launches_alive:
        # 1 camera ray per path + 1 per surviving bounce; NEE adds 1 shadow
        # ray per shading point (camera + bounces - 1)
        a = alive.cpu().numpy().astype(np.float64)   # exact past 2**24
        rays += n_paths + a.sum()
        if nee:
            rays += n_paths + a[:-1].sum()
    img = (acc / SPP).cpu().numpy()
    dt = time.time() - t0
    launches = mega.KERNEL_LAUNCHES
    if launches != per_sample * SPP:
        fail(f"kernel launches {launches}, want {per_sample * SPP}")
    light_launches = light_sample.KERNEL_LAUNCHES
    if light_launches != (per_sample * SPP if nee else 0):
        fail(f"light-sample launches {light_launches}, want "
             f"{per_sample * SPP if nee else 0}")
    draws["launches"] = rng.KERNEL_LAUNCHES
    if draws["launches"] != (per_sample + 2) * SPP:
        fail(f"threefry launches {draws['launches']}, want "
             f"{(per_sample + 2) * SPP} (one per segment, keys and camera)")
    if not np.isfinite(img).all() or not img.mean() > 0:
        fail(f"slice image broken: mean {img.mean()}")
    mrays = rays / dt / 1e6
    log(f"phase 4 slice: bunny stand-in {W}x{H} {SPP} spp {BOUNCES} bounces "
        f"in {dt:.3f} s, {rays:.0f} rays, {mrays:.3f} Mrays/s, "
        f"{launches} segment, {light_launches} light-sample and "
        f"{draws['launches']} threefry kernel launches, image mean "
        f"{img.mean():.5f} [{card}]")

    wave = wavefront_phases(scene, cfg, order, card)
    grad_launches = gradient_phases(scene, cfg, order, card)
    cli_launches = cli_phase(dev, card)
    par = parallel_phase(scene, order, card)
    sweep = sphere_sweep_phase(dev, card)
    shade = wave_shade_phase(dev, card)
    wave[0]["ring_launches"] = par["cull"]
    wave[1]["ring_launches"] = par["packet"]
    record = {"kernels": [{
        "name": "mega_segment", "route": "cuda",
        "source": "offline_raytracer_tpu_torch/csrc/mega.cu",
        "replaces": "offline_raytracer_tpu/ops/mega.py:418",
        "launches": launches, "grad_launches": grad_launches,
        "cli_launches": cli_launches, "sharded_launches": par["sharded"],
        "max_abs_err": max(r["err"] for r in results),
        "ms": results[0]["ms"], "plain_ms": results[0]["plain_ms"],
        "bound_ms": results[0]["bound_ms"],
        "bound_by": results[0]["bound_by"], "library_ms": None,
        "group": {x["b"]: x["group"] for x in segments},
        "segments": segments}] + wave + [draws, sweep, shade, {
        "name": "light_sample", "route": "cuda",
        "source": "offline_raytracer_tpu_torch/csrc/light_sample.cu",
        "replaces": None, "max_abs_err": 0.0, "launches": light_launches,
        "ms": sum(x[0] for x in lights),
        "plain_ms": sum(x[1] for x in lights),
        "bound_ms": sum(x[2] for x in lights), "bound_by": "bytes",
        "library_ms": None}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
