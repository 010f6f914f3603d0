"""Rays split over processes (counterpart of
``offline_raytracer_tpu/parallel/shard.py``).

The JAX package runs one program over a 1-D device mesh with ``shard_map``.
Here each rank is a process of a ``torch.distributed`` group, and a
``RankGroup`` (rank, world size, device, group) stands where the JAX
functions take a ``Mesh``:

- forward: pixel ids are cut into contiguous equal blocks, one per rank (the
  mesh's ``P("rays")``); the scene, BVH included, is whole on every rank;
  each rank renders its block with ``render.render_block`` and the blocks
  are gathered to every rank;
- backward: each rank differentiates the loss of its block and the loss and
  gradients are summed over the ranks (the mesh's ``psum``);
- determinism: the draws are counter-based per (pixel, sample) and every
  ray is computed on its own, so the image does not depend on the number of
  ranks.

Transport. The backend follows the device, NCCL for CUDA ranks and gloo for
CPU ranks, unless the caller names one: several ranks on one card need
gloo, since NCCL takes one rank per card. gloo moves host memory, so every
collective and point-to-point of a CUDA tensor under gloo goes through
``_wire``, which copies it to the host and back; the compute stays on the
card. Every group has a timeout, so a lost peer fails a collective instead
of hanging it. With the recorder on (``utils/profiling.py``) each
collective is a span (``shard.all_gather``, ``shard.all_reduce``,
``shard.ring_shift``) and counts the bytes of the tensor it returns on
this rank (``shard.bytes``). ``run_ranks`` starts one process per rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from offline_raytracer_tpu_torch.config import RenderConfig
from offline_raytracer_tpu_torch.render import render_block
from offline_raytracer_tpu_torch.scene.types import Scene, scene_device
from offline_raytracer_tpu_torch.utils import profiling

# seconds a collective waits for its slowest peer before it fails: longer
# than the longest render a rank makes between two collectives
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in a group of ranks: what the port's parallel
    functions take where the JAX ones take a ``Mesh``. ``group`` is the
    ``torch.distributed`` group, None for a single process that joined
    none (then every collective is the identity)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank`` for a ``device`` of "cuda" or "cpu": a
    CUDA rank runs on ``cuda:{LOCAL_RANK}`` (torchrun's local rank, else
    the rank) when there are that many cards, else on ``cuda:0``."""
    dev = scene_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local if local < torch.cuda.device_count()
                        else 0)


def init_process_group(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None, *, device="cuda",
                       backend: str | None = None,
                       init_method: str | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join this process to the default process group; returns its rank
    (the JAX package's ``init_multihost``). Idempotent: a second call
    returns the rank.

    The group comes from ``coordinator`` ("host:port" of rank 0),
    ``num_processes`` and ``process_id``, or from ``init_method`` (e.g.
    "file:///tmp/rdv"), or else from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card). The backend
    is "nccl" for a CUDA ``device`` and "gloo" for the CPU unless
    ``backend`` names one; "nccl" without a card raises."""
    if dist.is_initialized():
        return dist.get_rank()
    dev = scene_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device; CPU ranks "
                           "take gloo")
    if init_method is None:
        init_method = f"tcp://{coordinator}" if coordinator else "env://"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if backend == "nccl":
        # NCCL binds each rank to its card before the first collective
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(
        backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank()


def make_group(device="cuda") -> RankGroup:
    """The RankGroup of this process (the JAX package's ``make_mesh``):
    the default process group if one was joined, else a group of one."""
    if not dist.is_initialized():
        return RankGroup(0, 1, scene_device(device))
    rank = dist.get_rank()
    return RankGroup(rank, dist.get_world_size(), rank_device(device, rank),
                     dist.group.WORLD)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _wire(group: RankGroup, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the backend reads it: gloo reads host memory, so a CUDA
    tensor goes to the host; NCCL reads it on the card."""
    x = x.contiguous()
    if group.backend == "gloo" and x.device.type == "cuda":
        return x.cpu()
    return x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather(group: RankGroup, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank, on ``x``'s device (the JAX package's
    ``fetch_global``)."""
    if group.group is None:
        return x
    with profiling.span("shard.all_gather"):
        w = _wire(group, x)
        parts = [torch.empty_like(w) for _ in range(group.size)]
        dist.all_gather(parts, w, group=group.group)
        out = torch.cat(parts).to(x.device)
        profiling.count("shard.bytes", _nbytes(out))
    return out


def all_reduce_sum(group: RankGroup, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` on every rank."""
    if group.group is None:
        return x
    with profiling.span("shard.all_reduce"):
        w = _wire(group, x).clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group.group)
        profiling.count("shard.bytes", _nbytes(w))
        return w.to(x.device)


def ring_shift(group: RankGroup, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to rank + 1 and return what rank - 1 sent (the JAX ring's
    ``ppermute``). The send and the receive are posted together, so no
    rank waits on a send before its receive."""
    if group.size == 1:
        return x
    with profiling.span("shard.ring_shift"):
        w = _wire(group, x)
        got = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w, (group.rank + 1) % group.size,
                          group.group),
               dist.P2POp(dist.irecv, got, (group.rank - 1) % group.size,
                          group.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        profiling.count("shard.bytes", _nbytes(got))
        return got.to(x.device)


def rank_block(group: RankGroup, x):
    """This rank's contiguous block of ``x`` along dim 0 (the JAX package's
    ``global_sharded_array``); the length must divide by the group size."""
    n = x.shape[0]
    if n % group.size:
        raise ValueError(f"{n} rows do not split over {group.size} ranks")
    per = n // group.size
    return x[group.rank * per:(group.rank + 1) * per]


# ---------------------------------------------------------------------------
# the sharded render and gradient step
# ---------------------------------------------------------------------------


def render_block_sharded(scene: Scene, cfg: RenderConfig, group: RankGroup,
                         pixel_ids, sample_lo: int = 0,
                         n_samples: int | None = None):
    """Render ``pixel_ids`` (P,), the same on every rank, split over the
    ranks -> (P, 3) radiance on every rank. P must divide by the group
    size (pad with repeated ids). Each rank builds its segment tables once
    (``render_block``)."""
    n = cfg.spp if n_samples is None else n_samples
    out = render_block(scene, cfg, rank_block(group, pixel_ids), sample_lo, n)
    return all_gather(group, out)


def render_image_sharded(scene: Scene, cfg: RenderConfig,
                         group: RankGroup) -> np.ndarray:
    """Full sharded render -> (H, W, 3) float32 numpy on every rank, row 0
    = top. The pixel ids are padded to a multiple of the group size by
    repeating the first ones."""
    n = cfg.width * cfg.height
    pad = (-n) % group.size
    ids = (torch.arange(n + pad, device=group.device) % n).to(torch.int32)
    img = render_block_sharded(scene, cfg, group, ids)[:n]
    return img.cpu().numpy().reshape(cfg.height, cfg.width, 3)[::-1]


def grad_step_sharded(scene: Scene, cfg: RenderConfig, group: RankGroup,
                      pixel_ids, target, param_getter, param_setter):
    """One inverse-rendering gradient step, rays split over the ranks ->
    (loss, {name: gradient}), the same on every rank.

    ``param_getter(scene)`` -> {name: tensor} of the optimizable leaves;
    ``param_setter(scene, params)`` -> the scene holding them. ``pixel_ids``
    (P,) and ``target`` (P, 3) are whole on every rank. Each rank renders
    its block under autograd (on the segment route the replay
    ``cfg.grad_mode`` picks) and differentiates its sum of squared errors;
    the loss and the gradients are summed over the ranks in one all-reduce
    and divided by P * 3, the mean over the whole ray set."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in param_getter(scene).items()}
    img = render_block(param_setter(scene, params), cfg,
                       rank_block(group, pixel_ids), 0, cfg.spp)
    err = torch.sum((img - rank_block(group, target)) ** 2)
    grads = torch.autograd.grad(err, list(params.values()))
    flat = all_reduce_sum(group, torch.cat(
        [err.detach().reshape(1)] + [g.reshape(-1) for g in grads]))
    flat = flat / (pixel_ids.shape[0] * 3)
    out, at = {}, 1
    for k, g in zip(params, grads):
        out[k] = flat[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    return flat[0], out


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, size, fn, args, init_method, backend, device,
                timeout_s, threads, results):
    """A spawned rank: join the group, run ``fn(group, *args)``, report
    (rank, ok, result or traceback) on ``results``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process_group(num_processes=size, process_id=rank,
                           device=device, backend=backend,
                           init_method=init_method, timeout_s=timeout_s)
        out = fn(make_group(device), *args)
        results.put((rank, True, out))
    except Exception:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, size: int, *args, device="cuda", backend: str | None = None,
              init_method: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              deadline_s: float = 3600.0, threads: int | None = None) -> list:
    """Run ``fn(group, *args)`` in ``size`` new processes (spawn start
    method), one rank each -> [rank 0's result, rank 1's, ...].

    ``fn`` is a module-level function and its results pickle (numpy, not
    CUDA tensors). The group joins through ``init_method`` (default a free
    localhost TCP port) with the backend of ``init_process_group``, each
    collective waiting at most ``timeout_s``. For a CUDA ``device`` the
    kernels are built here first, so the ranks find them built. Raises if
    a rank raises or dies, at once, or if the ranks have not all finished
    within ``deadline_s``; stops every process it started either way.
    ``threads``: torch's intra-op threads per rank."""
    if scene_device(device).type == "cuda":
        from offline_raytracer_tpu_torch.ops import _kernels
        _kernels.build_all(_kernels.LIBRARIES)
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        r, size, fn, args, init_method, backend, device, timeout_s, threads,
        results)) for r in range(size)]
    done, failed = {}, {}
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while len(done) < size and not failed:
            left = end - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(size)) - set(done))
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{deadline_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        failed[r] = f"exited with code {p.exitcode}\n"
                continue
            (done if ok else failed)[rank] = value
        if failed:
            raise RuntimeError("".join(
                f"rank {r} of {size} failed:\n{msg}"
                for r, msg in sorted(failed.items())))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(size)]
