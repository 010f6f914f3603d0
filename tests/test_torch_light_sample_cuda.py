"""The light-sample kernel (``csrc/light_sample.cu``) vs its plain twin
(``light_sample.sample_planes_plain``, one ``lights.sample_lights`` call a
bounce) on the card: the same uniforms give every plane bit for bit, for a
table of one light of each kind (sphere, tilted cylinder, emissive box)
and for the showcase's six lights, at the showcase's full size (921,600
lanes, 4 bounces) and on a ragged lane count, edge uniforms included. Then
a full showcase sample through ``render_paths_mega`` with the kernel's
planes and with the plain twin's: radiance, hit ids, NEE visibility and
alive records bitwise equal, and the kernel's launches and counter. Last,
``time_planes`` times a showcase launch's four segments' planes through
the kernel and through the plain twin with CUDA events, and prints them.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest -s
tests/test_torch_light_sample_cuda.py``.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import light_sample, mega
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import profiling, rng
from torch_port_cases import light_kinds_recipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FULL = 1280 * 720           # the showcase's paths a launch
_SHOWCASE = {}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def _showcase(dev):
    """(scene, cfg) of the showcase configuration, built once."""
    if "scene" not in _SHOWCASE:
        from portbench.inputs import recipe

        with open(os.path.join(ROOT, "portbench", "configs",
                               "showcase.json")) as f:
            c = json.load(f)
        b = recipe.apply(SceneBuilder(), recipe.calls(c["scene"]),
                         c["camera"])
        cfg = RenderConfig(**c["render"])
        _SHOWCASE["scene"] = b.build(cfg.width, cfg.height, device=dev)
        _SHOWCASE["cfg"] = cfg
    return _SHOWCASE["scene"], _SHOWCASE["cfg"]


def _table(name, dev):
    if name == "showcase":
        scene = _showcase(dev)[0]
        assert scene.lights.count == 6
    else:
        scene = light_kinds_recipe(SceneBuilder, "scm").build(
            32, 32, device=dev)
    return scene.lights, scene.materials.emit


def _uniforms(Rp, nf, dev, seed=7):
    """(8 * nf, Rp) uniform planes as the loop draws them, the first 64
    lanes set to edge values (0 and the largest float below 1) in every
    combination of the four light-sample rows."""
    ids = torch.arange(Rp, dtype=torch.int32, device=dev) % FULL
    keys = rng.pixel_sample_keys(rng.render_key(seed, dev), ids,
                                 torch.zeros_like(ids))
    u = rng.uniform_planes(keys, 1, nf, 8)
    top = float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))
    lanes = torch.arange(min(Rp, 64), device=dev)
    for k in range(4):
        edge = torch.where((lanes >> k) & 1 == 1, top, 0.0)
        for i in range(nf):
            u[8 * i + k, :lanes.shape[0]] = edge
    return u


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("Rp, nf", [(FULL, 4), (1000, 3), (333, 1)])
@pytest.mark.parametrize("table", ["kinds", "showcase"])
def test_kernel_planes_are_the_plain_planes(device, table, Rp, nf):
    lights, emit = _table(table, device)
    u = _uniforms(Rp, nf, device)
    launches = light_sample.KERNEL_LAUNCHES
    got = light_sample.sample_planes(u, nf, lights, emit)
    assert light_sample.KERNEL_LAUNCHES == launches + 1
    want = light_sample.sample_planes_plain(u, nf, lights, emit)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (10 * nf, Rp)
    diff = (_bits(got) != _bits(want)).sum(1)
    assert int(diff.sum()) == 0, f"lanes differing per plane: {diff}"


def _sample(scene, cfg, dev, s=0):
    """ro, rd, keys of sample ``s`` of every pixel in the tile order."""
    from offline_raytracer_tpu_torch.render import tile_pixel_ids

    ids = torch.from_numpy(tile_pixel_ids(cfg.width, cfg.height)).to(dev)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed, dev), ids,
                                 torch.full_like(ids, s))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    return ro, rd, keys


@pytest.mark.cuda
def test_showcase_sample_is_bitwise_with_either_planes(device, monkeypatch):
    scene, cfg = _showcase(device)
    tables = mega.prepare_tables(scene, cfg)
    ro, rd, keys = _sample(scene, cfg, device)
    launches = light_sample.KERNEL_LAUNCHES
    with torch.no_grad(), profiling.recording():
        got = mega.render_paths_mega(scene, cfg, ro, rd, keys,
                                     collect_records=True, tables=tables)
        torch.cuda.synchronize()
    counters = profiling.flush()["counters"]
    segs = mega.segment_plan(cfg)[0]
    assert light_sample.KERNEL_LAUNCHES == launches + len(segs)
    assert counters["mega.light_kernel"] == FULL * cfg.max_bounces
    monkeypatch.setattr(light_sample, "sample_planes_cuda",
                        light_sample.sample_planes_plain)
    with torch.no_grad():
        want = mega.render_paths_mega(scene, cfg, ro, rd, keys,
                                      collect_records=True, tables=tables)
        torch.cuda.synchronize()
    assert light_sample.KERNEL_LAUNCHES == launches + len(segs)
    for name, g, w in zip(("radiance", "hit ids", "visibility", "alive"),
                          got, want):
        assert torch.equal(_bits(g), _bits(w)), name
    alive = got[3].sum(1)
    assert 0 < float(alive[-1]) < float(alive[0]) <= FULL


def time_planes(dev, reps=20) -> dict:
    """CUDA-event ms of a showcase launch's segments' light-sample planes
    (921,600 lanes; segments of 1, 1, 1 and 9 bounces) through the kernel
    and through the plain twin, each the mean of ``reps`` runs after a
    warm-up, and of each segment alone."""
    scene, cfg = _showcase(dev)
    lights, emit = scene.lights, scene.materials.emit
    out = {"device": torch.cuda.get_device_name(dev), "lanes": FULL}
    for name, fn in (("kernel", light_sample.sample_planes_cuda),
                     ("plain", light_sample.sample_planes_plain)):
        per = []
        for b, nf in mega.segment_plan(cfg)[0]:
            u = _uniforms(FULL, nf, dev, seed=b)
            fn(u, nf, lights, emit)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(u, nf, lights, emit)
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / reps)
        out[f"{name}_ms_per_segment"] = per
        out[f"{name}_ms_per_launch"] = sum(per)
    # bytes once: 4 uniforms read and 10 planes written a lane and bounce
    nb = FULL * cfg.max_bounces
    out["bound_ms_per_launch"] = nb * 56 / 3.35e12 * 1e3
    return out


@pytest.mark.cuda
def test_kernel_time_against_the_plain_span(device):
    t = time_planes(device)
    print("light_sample_times", json.dumps(t))
    assert t["kernel_ms_per_launch"] < t["plain_ms_per_launch"]


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    lights, emit = _table("kinds", device)
    u = _uniforms(512, 2, device)
    with pytest.raises(ValueError, match="u_all"):
        light_sample.sample_planes_cuda(u[:12], 2, lights, emit)
    with pytest.raises(ValueError, match="u_all"):
        light_sample.sample_planes_cuda(u.double(), 2, lights, emit)
    with pytest.raises(ValueError, match="emit"):
        light_sample.sample_planes_cuda(u, 2, lights, emit.cpu())
    with pytest.raises(ValueError, match="rot"):
        light_sample.sample_planes_cuda(
            u, 2, dataclasses.replace(lights, rot=lights.rot.double()), emit)
