"""The recorder (``utils/profiling.py``) on the card: a render bitwise
the same with it on and off, the live counter against the render's alive
counts, and, under ``torch.profiler`` with CUDA activities, every segment
kernel tied by its correlation id to a launch call made inside a
``mega.segment`` span.

Marked ``cuda``; it skips without a card. It imports no jax:
``python -m pytest -m cuda --noconftest tests/test_torch_tracing_cuda.py``.
"""

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.render import render_block_stats
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import profiling
from torch_port_cases import mesh_recipe

CFG = RenderConfig(width=64, height=64, spp=1, max_bounces=6,
                   enable_dof=False)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


@pytest.fixture
def case(device):
    scene = mesh_recipe(SceneBuilder, 9000).build(64, 64, device=device)
    with torch.no_grad():
        tables = mega.prepare_tables(scene, CFG)
    ids = torch.arange(64 * 64 - 100, dtype=torch.int32, device=device)
    profiling.disable()
    profiling.flush()
    yield scene, tables, ids
    profiling.disable()
    profiling.flush()


@pytest.mark.cuda
def test_bitwise_and_live_on_card(case):
    scene, tables, ids = case
    off = render_block_stats(scene, CFG, ids, 0, 2, tables)
    with profiling.recording():
        on = render_block_stats(scene, CFG, ids, 0, 2, tables)
    got = profiling.flush()["counters"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    alive = on[1].double().cpu()
    assert got["mega.live"] == 2 * ids.shape[0] + float(alive[:-1].sum())
    Rp = -(-ids.shape[0] // mega.BLOCK) * mega.BLOCK
    assert got["mega.lanes"] == 2 * Rp * CFG.max_bounces


@pytest.mark.cuda
def test_segment_kernels_launch_inside_segment_spans(case):
    from torch.autograd import DeviceType

    scene, tables, ids = case
    render_block_stats(scene, CFG, ids, 0, 1, tables)      # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with profiling.recording(), torch.profiler.profile(
            activities=acts) as prof:
        render_block_stats(scene, CFG, ids, 0, 1, tables)
        torch.cuda.synchronize()
    spans = profiling.flush()["spans"]
    segments, calls, kernels = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        # by name: torch builds before 2.13 give events no activity type
        if ev.device_type() == DeviceType.CPU:
            if ev.name() == "mega.segment":
                segments.append((ev.start_ns(), ev.end_ns()))
            elif ev.name().startswith("cu"):     # runtime or driver call
                calls[ev.correlation_id()] = ev.start_ns()
        elif "mega_kernel" in ev.name():
            kernels.append(ev.correlation_id())
    n_seg = len(mega.segment_plan(CFG)[0])
    assert len(kernels) == len(segments) == n_seg
    assert sum(s["name"] == "mega.segment" for s in spans) == n_seg
    for c in kernels:
        t = calls[c]
        assert any(s <= t <= e for s, e in segments)
