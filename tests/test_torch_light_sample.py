"""The segment route's light-sample planes (``ops/light_sample.py``) on the
CPU: the plain route's (10 * nf, Rp) planes are the per-bounce
``sample_lights`` planes they replaced, in the same layout; each sample
lies on its light, with a unit outward normal; the cylinder's rotation in
its fixed order is the einsum's within rounding; and the render loop hands
the segments these planes, zeros without NEE, and the kernel route's
counter. Here the CPU is also made to pass the device rule for the light
sample alone, with the kernel's launch replaced, to show where the loop
engages it. The kernel itself is held to the plain route on the card
(``tests/test_torch_light_sample_cuda.py``)."""

import pytest
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.ops import (
    _kernels, light_sample, lights, mega)
from offline_raytracer_tpu_torch.ops.camera import generate_rays
from offline_raytracer_tpu_torch.scene.build import SceneBuilder
from offline_raytracer_tpu_torch.utils import profiling, rng
from torch_port_cases import light_kinds_recipe

torch.set_num_threads(2)

R = 300                     # paths; padded to Rp = 512
TABLES = ["scm", "s", "c", "m"]


def _scene(kinds):
    return light_kinds_recipe(SceneBuilder, kinds).build(32, 32,
                                                         device="cpu")


def _uniforms(nf, b=1, seed=3):
    """(8 * nf, Rp) uniform planes as the loop draws them for bounces
    [b, b + nf), with the loop's padded keys."""
    Rp = -(-R // mega.BLOCK) * mega.BLOCK
    ids = torch.arange(R, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(seed), ids,
                                 torch.zeros_like(ids))
    keys = torch.cat([keys, keys[torch.arange(Rp - R) % R]])
    return rng.uniform_planes(keys, b, nf, 8)


def _per_bounce(u_all, nf, scene):
    """The planes as the loop made them before the kernel: one
    ``sample_lights`` call and one concatenation a bounce."""
    Rp = u_all.shape[1]
    out = []
    for i in range(nf):
        s = lights.sample_lights(u_all[8 * i:8 * i + 8][0:4].T,
                                 scene.lights, scene.materials.emit)
        out.append(torch.cat([s.p.T, s.normal.T, s.emit.T,
                              s.pdf_area[None]], 0))
        assert out[-1].shape == (10, Rp)
    return torch.cat(out, 0).contiguous()


@pytest.mark.parametrize("kinds", TABLES)
@pytest.mark.parametrize("nf", [1, 2, 3, 4])
def test_plain_planes_are_the_per_bounce_planes(kinds, nf):
    scene = _scene(kinds)
    u_all = _uniforms(nf)
    got = light_sample.sample_planes(u_all, nf, scene.lights,
                                     scene.materials.emit)
    want = _per_bounce(u_all, nf, scene)
    assert got.shape == (10 * nf, u_all.shape[1]) and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kinds", TABLES)
def test_samples_lie_on_their_lights(kinds):
    """Every kind of the table is picked, each point lies on its light
    (sphere surface; cylinder side or cap in the light's own frame; the
    emissive box's surface), the normal is a unit vector pointing out, and
    the emission and area pdf are the picked light's."""
    scene = _scene(kinds)
    lt = scene.lights
    L = lt.count
    assert L == len(kinds)
    u_all = _uniforms(2)
    planes = light_sample.sample_planes(u_all, 2, lt, scene.materials.emit)
    for i in range(2):
        u = u_all[8 * i:8 * i + 4]
        pl = planes[10 * i:10 * i + 10]
        p, n, emit, pdf = pl[0:3].T, pl[3:6].T, pl[6:9].T, pl[9]
        idx = torch.clamp((u[0] * L).to(torch.int32), max=L - 1).long()
        assert set(idx.tolist()) == set(range(L))
        torch.testing.assert_close(torch.linalg.vector_norm(n, dim=-1),
                                   torch.ones(p.shape[0]))
        torch.testing.assert_close(emit, scene.materials.emit[
            lt.mat[idx].long()], rtol=0, atol=0)
        torch.testing.assert_close(pdf, 1.0 / (lt.area[idx] * L))
        for k, kind in enumerate(kinds):
            sel = idx == k
            pk, nk = p[sel], n[sel]
            if kind == "s":
                d = pk - lt.p0[k]
                torch.testing.assert_close(
                    torch.linalg.vector_norm(d, dim=-1),
                    torch.full((pk.shape[0],), float(lt.radius[k])))
                torch.testing.assert_close(nk, d / lt.radius[k], atol=2e-6,
                                           rtol=0)
            elif kind == "c":
                q = (pk - lt.p0[k]) @ lt.rot[k].T     # the light's frame
                m = (nk @ lt.rot[k].T)
                h = float(torch.linalg.vector_norm(lt.axis[k]))
                r = float(lt.radius[k])
                rad = torch.linalg.vector_norm(q[:, :2], dim=-1)
                side = (rad - r).abs() < 1e-5
                cap = ((q[:, 2].abs() < 1e-5) | ((q[:, 2] - h).abs() < 1e-5))
                assert bool((side | cap).all())
                assert bool(side.any()) and bool(cap.any())
                assert bool((q[:, 2] > -1e-5).all() and (q[:, 2] < h + 1e-5)
                            .all() and (rad < r + 1e-5).all())
                torch.testing.assert_close(m[side][:, 2],
                                           torch.zeros(int(side.sum())),
                                           atol=1e-6, rtol=0)
                torch.testing.assert_close(m[~side][:, 2].abs(),
                                           torch.ones(int((~side).sum())))
            else:
                lo = torch.tensor([-0.5, -0.3, 2.4])
                hi = torch.tensor([0.7, 0.5, 2.6])
                on = ((pk - lo).abs() < 1e-5) | ((pk - hi).abs() < 1e-5)
                assert bool(on.any(-1).all())
                inside = (pk > lo - 1e-5) & (pk < hi + 1e-5)
                assert bool(inside.all())
                # the face's normal is one axis, pointing out of the box
                assert bool(((nk.abs() - 1).abs() < 1e-6).sum(-1).eq(1).all())


def test_rotation_is_the_einsums_in_a_fixed_order():
    """``lights._rot_t`` adds the rotated rows as ((row 0 + row 1) + row
    2), each product rounded: bit for bit that sum, and the einsum it
    replaced within float32 rounding."""
    g = torch.Generator().manual_seed(0)
    rot = torch.randn((5000, 3, 3), generator=g)
    v = torch.randn((5000, 3), generator=g)
    got = lights._rot_t(rot, v)
    want = torch.stack([(rot[:, 0, i] * v[:, 0] + rot[:, 1, i] * v[:, 1])
                        + rot[:, 2, i] * v[:, 2] for i in range(3)], -1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(got, torch.einsum("rji,rj->ri", rot, v),
                               rtol=0, atol=1e-5)


def _render(scene, nee, monkeypatch):
    """One 300-path sample through ``render_paths_mega`` with the recorder
    on: ([(u, ls, n_fused)] handed to each segment, the counters)."""
    cfg = RenderConfig(width=32, height=32, max_bounces=5, enable_dof=False,
                       enable_nee=nee, mega_sort_after=2, seed=4)
    ids = torch.arange(R, dtype=torch.int32)
    keys = rng.pixel_sample_keys(rng.render_key(cfg.seed), ids,
                                 torch.zeros_like(ids))
    ro, rd = generate_rays(scene.camera, cfg, ids, keys)
    seen = []
    original = mega.mega_segment

    def recording(state, u, ls, tables, seg):
        seen.append((u, ls, seg.n_fused))
        return original(state, u, ls, tables, seg)

    monkeypatch.setattr(mega, "mega_segment", recording)
    with profiling.recording():
        mega.render_paths_mega(scene, cfg, ro, rd, keys)
    counters = profiling.flush()["counters"]
    assert [nf for _, _, nf in seen] == [
        nf for _, nf in mega.segment_plan(cfg)[0]]
    return seen, counters


@pytest.mark.parametrize("nee", [True, False])
def test_loop_hands_the_segments_the_planes(nee, monkeypatch):
    """The loop's planes are the plain route's from each segment's own
    uniforms with NEE, zeros without; on the CPU no kernel launches and
    nothing counts the kernel's counter ``mega.light_kernel``."""
    scene = _scene("scm")
    launches = light_sample.KERNEL_LAUNCHES
    seen, counters = _render(scene, nee, monkeypatch)
    for u, ls, nf in seen:
        assert ls.shape == (10 * nf, u.shape[1]) and ls.is_contiguous()
        if nee:
            want = _per_bounce(u, nf, scene)
            assert torch.equal(ls.view(torch.int32), want.view(torch.int32))
        else:
            assert not bool(ls.any())
    assert "mega.light_kernel" not in counters
    assert light_sample.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("nee", [True, False])
def test_kernel_route_is_taken_once_a_segment(nee, monkeypatch):
    """With the CPU made to pass the device rule for the light sample
    alone, the loop calls the kernel's wrapper once a segment with NEE and
    never without. The loop counts nothing of the kernel's own: the
    wrapper counts ``mega.light_kernel`` at its launch (held on the card
    by ``tests/test_torch_light_sample_cuda.py``), and the stand-in here
    counts nothing."""
    scene = _scene("scm")
    rule = _kernels.takes_kernel
    calls = []

    def takes(device, what):
        return what == "light sample" or rule(device, what)

    def kernel(u_all, nf, lt, emit):
        calls.append(nf)
        return light_sample.sample_planes_plain(u_all, nf, lt, emit)

    monkeypatch.setattr(_kernels, "takes_kernel", takes)
    monkeypatch.setattr(light_sample, "sample_planes_cuda", kernel)
    seen, counters = _render(scene, nee, monkeypatch)
    Rp = seen[0][0].shape[1]
    assert calls == ([nf for _, _, nf in seen] if nee else [])
    assert "mega.light_kernel" not in counters
    assert counters["mega.lanes"] == Rp * sum(nf for _, _, nf in seen)


def test_kernel_wrapper_refuses_cpu_tensors():
    scene = _scene("s")
    with pytest.raises(ValueError, match="CUDA"):
        light_sample.sample_planes_cuda(_uniforms(1), 1, scene.lights,
                                        scene.materials.emit)
