"""One run of one benchmark cell: set-up, window, comparison, result line.

The harness is driven by data. ``BENCHMARK.json`` names each cell's
configuration and traffic mix; the harness finds, by those names:

- ``portbench/configs/<config>.json``: the scene recipe, the render
  settings and the camera (a configuration's file in ``BENCHMARK.json``);
- ``portbench/traffic/<traffic>.json``: the parameters of the loop the
  window drives, whose ``loop`` names ``portbench/loops/<loop>.py``
  (its ``Loop`` class, and its ``control`` for ``control.py``);
- ``portbench/limits/<workload>.json``: the limit of each number the
  comparison reads for that cell (``check.py``);
- ``portbench/metrics/<metric>.py``: one reader per metric, end-to-end
  and per-layer alike, each ``read(rec)`` -> a number or None.

``run`` makes the inputs from the seed, warms the cell's own shapes,
measures for ``seconds``, reads the device peak, frees the program's
state, compares what the window produced with the plain reference
(``portbench/reference``), and prints the result line. The program is the
PyTorch and CUDA port, ``offline_raytracer_tpu_torch``; nothing here
imports the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "offline_raytracer_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def bench_file():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names."""

    name: str
    workload: dict
    config: dict        # the configuration file's contents
    traffic: dict       # the traffic file's contents
    limits: dict        # {number: limit}
    end_to_end: list    # the BENCHMARK.json metrics this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, workload=w,
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       f"{w['traffic']}.json")),
        limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` (a name may hold dots),
    loaded once."""
    key = f"portbench_{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[key] = mod
    return mod


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    return module("metrics", name).read


def loop_module(cell: Cell):
    """The module of the loop the cell's traffic file names."""
    return module("loops", cell.traffic["loop"])


def read_metrics(chosen: list, rec: Record, require: bool) -> dict:
    """{name: {"value", "unit"}} of the metrics ``chosen`` that read a
    number. With ``require``, a metric that reads none fails the run: in
    a traced run on the card every per-layer metric declared for the cell
    has something to read, so one that reads nothing has lost its
    yardstick (a renamed kernel, a moved call)."""
    metrics, missing = {}, []
    for m in chosen:
        v = reader(m["name"])(rec)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if require and missing:
        raise SystemExit(f"metrics declared for the cell read nothing: "
                         f"{missing}")
    return metrics


def forbidden_modules(names=None) -> list:
    """Loaded modules (of ``names``, by default ``sys.modules``) whose
    top-level name is one of FORBIDDEN, compared whole (the port's name
    begins with the JAX package's)."""
    names = sys.modules if names is None else names
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """nvidia-smi's name, power limit and clocks of the cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.replace("\n", " | ")


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc cache is ``build/kernels/`` there already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


class Ctx:
    """What a loop needs: the cell, the seed, the device, the clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        from portbench.inputs import recipe

        self.cell = cell
        self.seed = int(seed)
        # the render's key is 32 bits; the benchmark's seeds may be larger
        self.seed32 = int(seed) % (1 << 32)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.spans: dict = {}
        with self.span("inputs_s"):
            self.made = recipe.calls(cell.config["scene"])
        self.camera = cell.config["camera"]
        self.render = dict(cell.config["render"])

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = (self.spans.get(name, 0.0)
                                + time.perf_counter() - t0)

    def sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float
    window_s: float
    attempted: int
    spans: dict
    values: dict                 # loop-specific measurements
    trace: object = None         # trace.TraceReading of a --trace 1 run


def device_block(device: str, count: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run(workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, cell: Cell | None = None, out=sys.stdout,
        err=sys.stderr) -> dict:
    """One run of ``workload``; prints the result line and returns it."""
    from portbench import check

    cell = cell or find_cell(bench_file(), workload)
    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    loop = loop_module(cell).Loop(ctx)
    rec = loop.measure()
    dev_block = device_block(device, cell.workload["chips"])
    print(f"card: {card_line()}", file=err, flush=True)
    if rec.trace is not None:
        dev_block["busy_s"] = rec.trace.busy_s()
        dev_block["window_s"] = rec.trace.window_s
    loop.free()
    t0 = time.perf_counter()
    numbers = loop.compare()
    print(f"timing: setup {rec.setup_s:.3f} s, window {rec.window_s:.3f} s, "
          f"{rec.attempted} attempted, comparison "
          f"{time.perf_counter() - t0:.3f} s, spans "
          f"{ {k: round(v, 3) for k, v in rec.spans.items()} }",
          file=err, flush=True)
    checks = check.judge(numbers, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    on_card = dev_block["platform"] == "gpu"
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           rec, on_card)
    result = {"correct": correct, "attempted": rec.attempted, "failed": 0,
              "metrics": metrics, "device": dev_block}
    if rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"FAIL: modules of the JAX package or JAX loaded: {found}",
              file=err, flush=True)
        raise SystemExit(3)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result
