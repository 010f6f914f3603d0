"""Checkpoint / resume (counterpart of ``offline_raytracer_tpu/utils/checkpoint.py``).

Two kinds of progress are durable:

- **Render accumulation** (``save_accum`` / ``load_accum``): the running
  radiance sum and the samples per pixel folded into it, written
  atomically as .npz after every spp chunk. Sample keys are counter-based
  (``utils/rng.py``), so a render resumed at the recorded sample index is
  bitwise the render an uninterrupted run makes. The .npz layout and its
  JSON meta are the JAX package's, and both packages' RenderConfigs have
  the same fields and defaults, so a checkpoint written by either package
  resumes in the other.
- **Inverse-rendering state** (``save_opt_state`` / ``load_opt_state``):
  the params, the optimizer's ``state_dict`` and the step, ``torch.save``d
  to ``<dir>/step_%08d/state.pt`` (the JAX package's orbax directory
  layout). torch needs no checkpointer object, so there is no
  ``opt_checkpointer``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile

import numpy as np
import torch


def _meta_of(cfg) -> dict:
    """The config fields that give the sums their meaning: the PERF_ONLY
    knobs (ray batch, traversal route, ...) change no estimate, so a render
    may resume under other values of them."""
    perf_only = set(getattr(cfg, "PERF_ONLY", ()))
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in perf_only}


def _meta_compatible(stored: dict, current: dict) -> bool:
    """Keys present in both must agree; a key only one side knows (an
    older or newer writer) is ignored."""
    return all(stored[k] == current[k] for k in stored.keys() & current.keys())


def save_accum(path: str, accum: np.ndarray, spp_done: int, cfg) -> None:
    """Atomically write the accumulation state for (cfg, spp_done)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, accum=np.asarray(accum, np.float32),
                     spp_done=np.int64(spp_done),
                     meta=np.frombuffer(
                         json.dumps(_meta_of(cfg)).encode(), np.uint8))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_accum(path: str, cfg):
    """(accum (P, 3) float32, spp_done) if the checkpoint at ``path``
    matches cfg, else None. A file of another config (size, seed,
    estimator knobs) counts as no checkpoint: its sums would blend another
    estimate into this one, and so does a file that is not such a
    checkpoint at all."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if not _meta_compatible(meta, _meta_of(cfg)):
                return None
            return np.asarray(z["accum"], np.float32), int(z["spp_done"])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}",
                        "state.pt")


def save_opt_state(directory: str, step: int, params: dict,
                   opt_state: dict) -> None:
    """Save one inverse-rendering step: params (name -> tensor), the
    optimizer's ``state_dict()`` and the step, atomically."""
    path = _step_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"params": {k: v.detach() for k, v in params.items()},
                "opt_state": opt_state, "step": int(step)}, tmp)
    os.replace(tmp, path)


def latest_opt_step(directory: str) -> int | None:
    """The highest step saved under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_") and n.split("_")[1].isdigit()
             and os.path.exists(_step_path(directory, int(n.split("_")[1])))]
    return max(steps) if steps else None


def load_opt_state(directory: str, step: int, device=None):
    """(params, opt_state) saved at ``step``, on ``device`` (default: as
    saved). Loads with torch's ``weights_only`` default: the state is
    tensors, numbers and lists."""
    out = torch.load(_step_path(directory, step), map_location=device)
    return out["params"], out["opt_state"]
