"""``grad``: inverse-rendering steps, as ``diff.optimize`` runs them.

Step k is the L2 loss of ``diff.make_loss_fn`` at 1 sample per pixel
(sample k) over every ``pixel_stride``-th pixel of the tile order, against
a target the reference renders in set-up from the true scene at
``target_spp``; ``torch.autograd.grad`` with respect to the albedo, the
emission and the mesh's first vertices (set on the scene by this loop's
setter); the port's guards on the albedo's and the emission's gradients,
then ``torch.optim.Adam`` (``lr``) on those two. The mesh's material
starts at ``wrong_albedo``. Set-up runs the first ``checked_steps`` steps
through the same call (the reference follows them), then the window runs
steps until ``--seconds`` have passed, each closed by the loss's value on
the host. The target is the benchmark's input, made by the reference: its
seconds (the ``target_s`` span) are left out of ``setup_s``, and the
device's memory peak is counted from after it. Parameters also:
``grad_mode``; ``trace_steps``: steps profiled in a ``--trace 1`` run,
each with its forward and backward synchronised at their ends.
"""

from __future__ import annotations

import time

from portbench import check
from portbench.common import (
    TARGET_SAMPLE, launch_counts, reference_setup, route_check)
from portbench.harness import Record
from portbench.trace import Tracer


def inputs(ctx, dev):
    """(pixel ids, target (P, 3), the mesh's material): the benchmark's
    inputs, the target rendered by the reference."""
    import torch

    from portbench.inputs import recipe
    from portbench.reference.paths import trace

    tr = ctx.cell.traffic
    sc, cfg = reference_setup(ctx)
    ids = torch.from_numpy(recipe.tile_pixel_ids(cfg.width, cfg.height)
                           )[::int(tr["pixel_stride"])].to(dev)
    spp = int(tr["target_spp"])
    pix = ids.repeat(spp)
    smp = TARGET_SAMPLE + torch.arange(spp, device=dev).repeat_interleave(
        ids.shape[0])
    rad, _ = trace(sc, cfg, pix, smp)
    target = rad.reshape(spp, ids.shape[0], 3).mean(0)
    mesh_mat = int(sc.tri_mat[0])
    return ids.contiguous(), target.contiguous(), mesh_mat


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.cell.traffic

    def measure(self) -> Record:
        import dataclasses

        import torch
        from offline_raytracer_tpu_torch import diff
        from offline_raytracer_tpu_torch.config import RenderConfig
        from offline_raytracer_tpu_torch.ops import mega
        from offline_raytracer_tpu_torch.scene.build import SceneBuilder

        from portbench.inputs import recipe

        ctx = self.ctx
        tr = self.tr
        dev = torch.device(ctx.device)
        on_card = dev.type == "cuda"
        with ctx.span("target_s"):
            self.ids, self.target, self.mesh_mat = inputs(ctx, dev)
            ctx.sync()
        if on_card:
            # the program's peak: from here on, with the inputs resident
            torch.cuda.reset_peak_memory_stats()
        cfg = RenderConfig(**ctx.render, seed=ctx.seed32, spp=1,
                           grad_mode=tr["grad_mode"])
        with ctx.span("scene_build_s"):
            b = recipe.apply(SceneBuilder(), ctx.made, ctx.camera)
            scene = b.build(cfg.width, cfg.height, device=dev)
            if not mega.mega_ok(scene, cfg):
                raise SystemExit("the scene does not fit the segment kernel")
            ctx.sync()
        kd = scene.materials.diffuse.clone()
        kd[self.mesh_mat] = torch.tensor(tr["wrong_albedo"], device=dev)
        self.start = {"diffuse": kd, "emit": scene.materials.emit.clone()}
        P = {k: x.clone().requires_grad_(True) for k, x in self.start.items()}
        P["v0"] = scene.triangles.v0.clone().requires_grad_(True)
        opt = torch.optim.Adam([P["diffuse"], P["emit"]], lr=float(tr["lr"]),
                               betas=(0.9, 0.999), eps=1e-8)

        def setter(sc, p):
            sc = diff.apply_material_params(sc, p)
            return dataclasses.replace(sc, triangles=dataclasses.replace(
                sc.triangles, v0=p["v0"]))

        loss_fn = diff.make_loss_fn(scene, cfg, self.target, self.ids,
                                    setter)
        leaves = [P["diffuse"], P["emit"], P["v0"]]
        n_seg = len(mega.segment_plan(cfg)[0])
        spans = {"forward": [], "backward": []}

        def step(k, timed=False):
            c0 = launch_counts()
            if timed:
                ctx.sync()
                t0 = time.perf_counter()
            loss = loss_fn(P, k)
            if timed:
                ctx.sync()
                t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]
            if timed:
                ctx.sync()
                spans["forward"].append(t1 - t0)
                spans["backward"].append(time.perf_counter() - t1)
            guarded = diff._guard(grads[:2])
            P["diffuse"].grad, P["emit"].grad = guarded
            opt.step()
            value = loss.item()
            if on_card:
                route_check(c0, n_seg, f"step {k}")
            return value, grads

        n_check = int(tr["checked_steps"])
        n_trace = int(tr["trace_steps"]) if ctx.trace else 0
        tracer = reading = None
        if n_trace:
            tracer = Tracer(n_check, n_trace)
            tracer.start()
        self.losses = []
        for k in range(n_check):
            loss, grads = step(k)
            self.losses.append(loss)
            if k == 0:
                # the gradient as Adam got it: its first moment / (1 - b1)
                self.first = {
                    name: opt.state[P[name]].get(
                        "exp_avg", torch.zeros_like(P[name])) / (1 - 0.9)
                    for name in ("diffuse", "emit")}
                self.first["v0"] = grads[2].detach()
            if tracer is not None:
                tracer.step()
        self.after = {k: P[k].detach().clone() for k in ("diffuse", "emit")}

        t_first = time.perf_counter()
        setup_s = t_first - ctx.t_start - ctx.spans["target_s"]
        deadline = t_first + ctx.seconds
        n = 0
        while True:
            timed = n < n_trace
            step(n_check + n, timed)
            n += 1
            t1 = time.perf_counter()
            if timed:
                tracer.step()
                if n == n_trace:
                    reading = tracer.stop(t1 - t_first, n_trace)
            if t1 >= deadline:
                break
        if tracer is not None and reading is None:
            reading = tracer.stop(t1 - t_first, n)
        return Record(
            setup_s=setup_s, window_s=t1 - t_first, attempted=n,
            spans=dict(ctx.spans), trace=reading,
            values={"steps": n, "forward_s": spans["forward"],
                    "backward_s": spans["backward"]})

    def free(self):
        """The program's state went with ``measure``'s locals."""
        import torch

        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        """The three numbers of the training comparison (``check.py``)."""
        from portbench.reference import inverse

        sc, cfg = reference_setup(self.ctx)
        ref = inverse.follow(sc, cfg, self.start, self.ids, self.target,
                             float(self.tr["lr"]),
                             int(self.tr["checked_steps"]))
        return check.training_numbers(
            self.losses, self.first, self.after, self.start, ref)


def control(ctx, launches: int, precision: str, fault=None) -> dict:
    """The comparison's numbers with the reference at ``precision`` in the
    program's place over the checked steps, with ``fault`` planted
    (``reference/inverse.py``) if given; ``launches`` is not used."""
    import torch

    from portbench.reference import inverse

    tr = ctx.cell.traffic
    sc, cfg = reference_setup(ctx)
    ids, target, mesh_mat = inputs(ctx, torch.device(ctx.device))
    kd = sc.mats["diffuse"].clone()
    kd[mesh_mat] = torch.tensor(tr["wrong_albedo"], device=kd.device)
    start = {"diffuse": kd, "emit": sc.mats["emit"].clone()}
    lr, steps = float(tr["lr"]), int(tr["checked_steps"])
    ctl = inverse.follow(sc, cfg, start, ids, target, lr, steps, precision,
                         fault)
    ref = inverse.follow(sc, cfg, start, ids, target, lr, steps)
    return check.training_numbers(ctl["losses"], ctl["first_grads"],
                                  ctl["params"], start, ref)
