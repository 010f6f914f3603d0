"""Spans, counters, ray counting and device traces (counterpart of
``offline_raytracer_tpu/utils/profiling.py``).

- ``span(name)`` (or ``@spanned(name)``) and ``count(name, n)``: the
  program's spans and counters, written to one module-level ``Recorder``
  that is off by default. Off, a call site costs one check of a module
  global and gets a shared no-op context. On (``enable``, ``disable``,
  ``recording``), each span records its name, id, parent id, root id (the
  outermost span it runs in) and start and end in ``time.time_ns()``
  nanoseconds, the clock of ``torch.profiler``'s host events; while a
  profiler records, each span also enters
  ``torch.profiler.record_function(name)``, so the trace holds the
  program's spans beside the operations they issued. A counter adds
  Python numbers at once and keeps device tensors to sum at ``flush``, so
  no counter waits for the device;
- ``RenderMeter``: rays/s from the integrator's own per-bounce alive
  counts (``render.render_block_stats``), summed in float64 so the count
  stays exact past 2**24 rays;
- ``device_trace``: ``torch.profiler`` over the CPU and, when there is a
  card, CUDA activities, written as a Chrome trace (chrome://tracing,
  Perfetto) into a directory, with the recorder's spans and counters
  beside it (``spans.jsonl``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


class _NoSpan:
    """The context every span call site gets while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "root", "start", "rf")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.id = next(rec._ids)
        if stack:
            self.parent = stack[-1].id
            self.root = stack[-1].root
        else:
            self.parent = None
            self.root = self.id
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec._spans.append((self.name, self.id, self.parent, self.root,
                           self.start, end, threading.get_ident()))
        return False


class Recorder:
    """Finished spans and counter totals since the last ``flush``.

    Spans nest per thread: a span's parent is the innermost span open on
    its own thread when it began (autograd runs a CUDA backward on a thread
    of its own, where a span starts a root of its own)."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._spans = []
        self._numbers = {}
        self._tensors = {}

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n) -> None:
        with self._lock:
            if isinstance(n, torch.Tensor):
                self._tensors.setdefault(name, []).append(n.detach())
            else:
                self._numbers[name] = self._numbers.get(name, 0) + n

    def flush(self) -> dict:
        """{"spans": [span dicts in the order they ended], "counters":
        {name: total}}; the recorder starts empty again. Spans still open
        are kept for the next flush."""
        with self._lock:
            spans, numbers, tensors = self._spans, self._numbers, self._tensors
            self._spans, self._numbers, self._tensors = [], {}, {}
        counters = dict(numbers)
        for name, parts in tensors.items():
            total = float(sum(p.double().sum() for p in parts))
            counters[name] = counters.get(name, 0) + total
        keys = ("name", "id", "parent", "root", "start_ns", "end_ns",
                "thread")
        return {"spans": [dict(zip(keys, s)) for s in spans],
                "counters": counters}


_ON = False
_RECORDER = Recorder()


def span(name: str):
    """A context recording one span of ``name`` while the recorder is on."""
    if not _ON:
        return _NO_SPAN
    return _RECORDER.span(name)


def spanned(name: str):
    """Decorator: each call of the function is a span of ``name`` while
    the recorder is on."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _RECORDER.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n) -> None:
    """Add ``n`` (a Python number or a device tensor, summed at ``flush``)
    to counter ``name`` while the recorder is on."""
    if _ON:
        _RECORDER.count(name, n)


def enabled() -> bool:
    return _ON


def enable() -> Recorder:
    global _ON
    _ON = True
    return _RECORDER


def disable() -> None:
    global _ON
    _ON = False


@contextlib.contextmanager
def recording():
    """The recorder on for the block (left on if it was on before);
    yields it."""
    was = _ON
    rec = enable()
    try:
        yield rec
    finally:
        if not was:
            disable()


def flush() -> dict:
    """The recorder's spans and counter totals (``Recorder.flush``)."""
    return _RECORDER.flush()


def span_totals(spans) -> dict:
    """{name: {"count", "seconds"}} over the spans of a flush."""
    out = {}
    for s in spans:
        t = out.setdefault(s["name"], {"count": 0, "seconds": 0.0})
        t["count"] += 1
        t["seconds"] += (s["end_ns"] - s["start_ns"]) / 1e9
    return out


def write_jsonl(path: str) -> dict:
    """``flush`` the recorder into ``path``: one JSON line per span
    ({"span": name, ...}) and one per counter ({"counter": name, "value":
    total}); returns what was written."""
    flushed = flush()
    with open(path, "w") as f:
        for s in flushed["spans"]:
            f.write(json.dumps({"span": s["name"], **{
                k: v for k, v in s.items() if k != "name"}}) + "\n")
        for name, value in flushed["counters"].items():
            f.write(json.dumps({"counter": name, "value": value}) + "\n")
    return flushed


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
    trace, ``trace.json``) with the recorder on, its spans and counters
    written beside it (``spans.jsonl``), when log_dir is set; nothing
    otherwise."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write_jsonl(os.path.join(log_dir, "spans.jsonl"))
