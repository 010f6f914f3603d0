"""Timing, ray counting and device traces (counterpart of
``offline_raytracer_tpu/utils/profiling.py``).

- ``PhaseTimer``: named wall-clock phases (scene load, BVH build, render,
  write), emitted as one JSON line;
- ``RenderMeter``: rays/s from the integrator's own per-bounce alive
  counts (``render.render_block_stats``), summed in float64 so the count
  stays exact past 2**24 rays;
- ``device_trace``: ``torch.profiler`` over the CPU and, when there is a
  card, CUDA activities, written as a Chrome trace (chrome://tracing,
  Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np


class PhaseTimer:
    """Named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("bvh_build"):
    ...     ...
    >>> t.emit()              # one JSON line on stderr
    """

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - start

    def total(self) -> float:
        return time.time() - self._t0

    def as_dict(self) -> dict:
        d = dict(self.phases)
        d["total"] = round(self.total(), 4)
        return d

    def emit(self, extra: dict | None = None, file=None) -> None:
        rec = {"event": "timing",
               **{k: round(v, 4) for k, v in self.phases.items()},
               "total": round(self.total(), 4)}
        if extra:
            rec.update(extra)
        print(json.dumps(rec), file=file or sys.stderr, flush=True)


@dataclass
class RenderMeter:
    """Rays/s and per-bounce occupancy.

    ``add_launch`` records one launch of ``n_paths`` paths with the
    integrator's per-bounce alive counts: every path has a camera segment
    and one more per bounce it survives, and with NEE one shadow ray per
    shading point (the camera hit and every surviving bounce but the last).
    """

    paths: int = 0
    segments: float = 0.0
    shadow_rays: float = 0.0
    seconds: float = 0.0
    launches: int = 0
    bounce_histogram: list = field(default_factory=list)

    def add_launch(self, n_paths: int, alive_per_bounce, nee_enabled: bool,
                   seconds: float) -> None:
        alive = np.asarray(alive_per_bounce, np.float64).reshape(-1)
        self.paths += int(n_paths)
        self.segments += float(n_paths + alive.sum())
        if nee_enabled:
            self.shadow_rays += float(n_paths + alive[:-1].sum())
        self.seconds += float(seconds)
        self.launches += 1
        if len(self.bounce_histogram) < alive.size:
            self.bounce_histogram += [0.0] * (alive.size
                                              - len(self.bounce_histogram))
        for i, a in enumerate(alive):
            self.bounce_histogram[i] += float(a)

    @property
    def total_rays(self) -> float:
        return self.segments + self.shadow_rays

    def mrays_per_s(self) -> float:
        return self.total_rays / max(self.seconds, 1e-9) / 1e6

    def as_dict(self) -> dict:
        return {
            "event": "render_meter",
            "paths": self.paths,
            "segments": round(self.segments),
            "shadow_rays": round(self.shadow_rays),
            "rays": round(self.total_rays),
            "seconds": round(self.seconds, 4),
            "mrays_per_s": round(self.mrays_per_s(), 3),
            "mean_path_length": round(self.segments / max(self.paths, 1), 3),
        }

    def emit(self, file=None) -> None:
        print(json.dumps(self.as_dict()), file=file or sys.stderr, flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block into ``log_dir`` (a Chrome
    trace, ``trace.json``) when log_dir is set; nothing otherwise."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
