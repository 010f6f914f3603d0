"""The port's ``parallel/`` on the CPU: gloo ranks spawned by
``parallel.shard.run_ranks`` (one thread each, ``file://`` rendezvous in a
temporary directory, a 60 s group timeout and a join deadline), held
against the port's single-process render and against the JAX package's
``parallel/`` on the 8-device CPU mesh of ``tests/conftest.py``.

Scenes: the analytic scene and ``mesh_recipe`` with 1,152 triangles (9
leaves) at 16x16, 2 spp, 3 bounces. Bounds: a sharded image and gradient
as ``tests/test_parallel.py`` holds the JAX ones (rtol 1e-5 / atol 1e-6;
rtol 1e-4 / atol 1e-7); the ring's image within rtol 1e-4 / atol 1e-5 and
its occlusion bits equal; the port against the JAX package within
``torch_port_cases.assert_close`` (renders) and ``tests/test_torch_diff.py``'s
rtol 1e-3 (gradients); BVH shards within the builder allowance of
``torch_port_cases.assert_scenes_equal``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.config import RenderConfig as JaxConfig
from offline_raytracer_tpu.parallel import ring as jax_ring
from offline_raytracer_tpu.parallel import shard as jax_shard
from offline_raytracer_tpu.scene.build import SceneBuilder as JaxBuilder
from offline_raytracer_tpu_torch import cli
from offline_raytracer_tpu_torch.ops.traverse import (
    make_bvh_occlusion_fn, make_bvh_trace_fn)
from offline_raytracer_tpu_torch.parallel import ring, shard
from offline_raytracer_tpu_torch.render import render_block
from offline_raytracer_tpu_torch.utils import hdr
import torch_parallel_cases as C
from torch_port_cases import (
    analytic_recipe, assert_close, far_origin_rays, mesh_recipe)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 60.0       # each collective's wait for its slowest peer
DEADLINE_S = 240.0     # every rank of a run_ranks call done by then
JCFG = JaxConfig(width=16, height=16, spp=2, max_bounces=3, enable_dof=False)
JAX_SCENES = {"mesh": lambda: mesh_recipe(JaxBuilder, C.MESH_TRIS),
              "analytic": lambda: analytic_recipe(JaxBuilder)}


def _run(fn, n, tmp_path_factory):
    store = tmp_path_factory.mktemp("rdv") / "store"
    out = shard.run_ranks(fn, n, device="cpu", init_method=f"file://{store}",
                          timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S,
                          threads=1)
    assert len(out) == n
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{2: every rank's sharded_renders, 4: every rank's all_cases}."""
    return {2: _run(C.sharded_renders, 2, tmp_path_factory),
            4: _run(C.all_cases, 4, tmp_path_factory)}


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


def _jax_scene(name):
    return JAX_SCENES[name]().build(16, 16)


def _jax_ids():
    return jnp.arange(256, dtype=jnp.int32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["mesh", "analytic"])
def test_shard_invariance(ranks, n, name):
    """A sharded render equals the single-process render_block of the same
    pixels (tests/test_parallel.py:23-38), on every rank; the draws are
    per (pixel, sample), so it is bitwise the same here."""
    got = _same_on_every_rank(ranks[n], name)
    want = render_block(C.scene(name), C.CFG, C.pixel_ids(), 0, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got.view(np.int32) != want.view(np.int32)).sum() == 0
    assert got.mean() > 0


@pytest.mark.parametrize("name", ["mesh", "analytic"])
def test_sharded_render_matches_jax(ranks, name):
    """The 4-rank render against the JAX render_block_sharded on 4 devices."""
    mesh = jax_shard.make_mesh(jax.devices()[:4])
    want = np.asarray(jax_shard.render_block_sharded(
        _jax_scene(name), JCFG, mesh, _jax_ids(), 0, 2))
    assert_close(want, _same_on_every_rank(ranks[4], name))


def _unsharded_grads(scene):
    params = {k: v.clone().requires_grad_(True)
              for k, v in C.get_params(scene).items()}
    img = render_block(C.set_params(scene, params), C.CFG, C.pixel_ids(), 0,
                       C.CFG.spp)
    loss = torch.sum(img ** 2) / (256 * 3)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(params, grads)}


def test_sharded_grad_matches_unsharded(ranks):
    """grad_step_sharded at 4 ranks (d/d albedo, d/d sphere centres, loss
    against a zero target) equals the single-process gradient of the same
    mean (tests/test_parallel.py:41-66)."""
    loss = _same_on_every_rank(ranks[4], "loss")
    grads = ranks[4][0]["grads"]
    for o in ranks[4][1:]:
        for k in grads:
            np.testing.assert_array_equal(o["grads"][k], grads[k])
    ref_loss, ref = _unsharded_grads(C.scene("analytic"))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for k, g in grads.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        np.testing.assert_allclose(g, ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_sharded_grad_matches_jax(ranks):
    """Against the JAX grad_step_sharded on 4 devices: the same loss and
    parameters, within tests/test_torch_diff.py's rtol 1e-3 (atol 1e-6 of
    the largest gradient, for entries near 0)."""
    js = _jax_scene("analytic")

    def getter(sc):
        return {"diffuse": sc.materials.diffuse, "center": sc.spheres.center}

    def setter(sc, p):
        return sc.replace(
            materials=sc.materials.replace(diffuse=p["diffuse"]),
            spheres=sc.spheres.replace(center=p["center"]))

    loss, grads = jax_shard.grad_step_sharded(
        js, JCFG, jax_shard.make_mesh(jax.devices()[:4]), _jax_ids(),
        jnp.zeros((256, 3)), getter, setter)
    np.testing.assert_allclose(float(ranks[4][0]["loss"]), float(loss),
                               rtol=1e-3)
    for k, g in ranks[4][0]["grads"].items():
        want = np.asarray(grads[k])
        np.testing.assert_allclose(g, want, rtol=1e-3,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_bvh_shards_match_jax(n_shards):
    """build_bvh_shards against the JAX one: global ids equal, planes and
    child rows within the builder allowance, every triangle in a shard
    (tests/test_parallel.py:189-200), sub-boxes present."""
    sc = C.scene("mesh")
    v = [x.numpy() for x in (sc.triangles.v0, sc.triangles.v1,
                             sc.triangles.v2)]
    cr, pl, ti, p, m = jax_ring.build_bvh_shards(*v, n_shards)
    got = ring.build_bvh_shards(*v, n_shards)
    assert len(got) == n_shards
    for s, b in enumerate(got):
        assert (b.n_leaves, b.m_occ) == (p, m)
        np.testing.assert_array_equal(b.tri_index.numpy(), np.asarray(ti[s]))
        np.testing.assert_allclose(b.planes.numpy(), np.asarray(pl[s]),
                                   rtol=2e-5, atol=1e-5)
        c_j = np.asarray(cr[s])[:, :12]
        c_t = b.child_rows.numpy()[:, :12]
        big = np.abs(c_j) > 1e29
        np.testing.assert_allclose(c_t[~big], c_j[~big], rtol=1e-6)
        assert (np.abs(c_t[big]) > 1e29).all()
        assert b.sub_bounds is not None
    ids = np.concatenate([b.tri_index.numpy() for b in got])
    assert np.unique(ids[ids >= 0]).size == v[0].shape[0]


def test_ring_shard_holds_its_share(ranks):
    """Each rank's shard holds ceil(n / (4 * 128)) leaves of slots, a
    quarter of the whole tree's rounded up to whole leaves, and the empty
    tail shards take their one repeated triangle."""
    per = -(-C.MESH_TRIS // (4 * 128)) * 128
    whole = C.scene("mesh").tri_bvh.tri_index.shape[0]
    for o in ranks[4]:
        assert per <= o["slots"] < whole


def test_ring_occlusion_matches_replicated(ranks):
    """Any-hit through the 4-rank ring equals the replicated query bit for
    bit on shadow rays of the mesh scene (tests/test_parallel.py:136-186),
    some occluded and some not."""
    got = _same_on_every_rank(ranks[4], "occluded")
    ro, rd, tf = (torch.from_numpy(x) for x in C.shadow_rays())
    want = make_bvh_occlusion_fn(C.scene("mesh"), C.CFG)(ro, rd, tf).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum()) < want.size


@pytest.mark.parametrize("n", [2, 4])
def test_ring_render_matches_replicated(ranks, n):
    """The ring's render equals the replicated wavefront render (the cull
    route's queries on the whole tree) within tests/test_parallel.py
    :132-133's bounds."""
    got = _same_on_every_rank(ranks[n], "ring")
    want = render_block(C.scene("mesh"), C.CFG.replace(traversal="cull"),
                        C.pixel_ids(), 0, 2).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_render_matches_jax(ranks, n):
    """Against the JAX render_block_ring on n devices, same bounds."""
    mesh = jax_shard.make_mesh(jax.devices()[:n])
    want = np.asarray(jax_ring.render_block_ring(
        _jax_scene("mesh"), JCFG, mesh, _jax_ids(), 0, 2))
    np.testing.assert_allclose(_same_on_every_rank(ranks[n], "ring"), want,
                               rtol=1e-4, atol=1e-5)


def test_ring_keeps_far_origin_hits(ranks):
    """Rays from 2e7 above a triangle 2e6 across (torch_port_cases
    .far_origin_recipe), through the 4-rank ring's closest-hit function
    with every 6th lane not alive: the replicated function's hits and t on
    the live lanes, every downward live ray a hit, no hit on a dead lane."""
    valid = _same_on_every_rank(ranks[4], "far_valid")
    t = _same_on_every_rank(ranks[4], "far_t")
    sc = C.scene("far")
    ro, rd = (torch.from_numpy(x) for x in far_origin_rays())
    alive = C.far_alive(ro.shape[0])
    hit = make_bvh_trace_fn(sc, C.CFG.replace(traversal="cull"))(
        ro, rd, torch.from_numpy(alive))
    np.testing.assert_array_equal(valid, hit.valid.numpy())
    np.testing.assert_array_equal(t[valid], hit.t.numpy()[valid])
    down = np.ones(ro.shape[0], bool)
    down[::4] = False
    assert (valid == (down & alive)).all()


def _cli_flags(tmp_path, name, *extra):
    return ["--preset", "analytic", "--width", "16", "--height", "16",
            "--spp", "2", "--max-bounces", "4", "--no-dof", "--device",
            "cpu", "--out", str(tmp_path / f"{name}.hdr"), *extra]


@pytest.fixture(scope="module")
def cli_single(tmp_path_factory):
    """The non-sharded command line's .hdr, read back."""
    tmp = tmp_path_factory.mktemp("cli")
    assert cli.main(_cli_flags(tmp, "single")) == 0
    return hdr.read_hdr(str(tmp / "single.hdr"))


def test_cli_multihost_two_processes(tmp_path, cli_single):
    """``python -m ... --multihost --coordinator 127.0.0.1:<port>
    --num-processes 2 --process-id i --device cpu`` in two processes:
    rank 0 writes the non-sharded command line's image and prints the JSON
    line, rank 1 writes and prints nothing."""
    addr = f"127.0.0.1:{shard.free_port()}"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "offline_raytracer_tpu_torch.cli",
         *_cli_flags(tmp_path, f"r{i}", "--multihost", "--coordinator", addr,
                     "--num-processes", "2", "--process-id", str(i))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=DEADLINE_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    line = json.loads(outs[0][0].strip().splitlines()[-1])
    assert (line["width"], line["spp"]) == (16, 2)
    assert "{" not in outs[1][0]
    assert not (tmp_path / "r1.hdr").exists()
    np.testing.assert_array_equal(hdr.read_hdr(str(tmp_path / "r0.hdr")),
                                  cli_single)


def test_cli_sharded_spawns_ranks(capsys, tmp_path, cli_single):
    """``--sharded --device cpu``: one spawned gloo rank renders the
    non-sharded image."""
    assert cli.main(_cli_flags(tmp_path, "s", "--sharded")) == 0
    np.testing.assert_array_equal(hdr.read_hdr(str(tmp_path / "s.hdr")),
                                  cli_single)


@pytest.mark.parametrize("flag", ["--checkpoint", "--meter"])
@pytest.mark.parametrize("mode", ["--sharded", "--multihost"])
def test_cli_refuses_sharded_checkpoint_and_meter(capsys, tmp_path, flag,
                                                  mode):
    """The JAX CLI's --sharded drops --checkpoint (cli.py:144-148) and
    feeds no --meter; the port refuses both before it renders."""
    extra = [flag] + ([str(tmp_path / "c.npz")] if flag == "--checkpoint"
                      else [])
    with pytest.raises(SystemExit):
        cli.main(_cli_flags(tmp_path, "x", mode, *extra))
    assert "do not combine with --sharded" in capsys.readouterr()[1]
    assert not (tmp_path / "x.hdr").exists()


# rank function -> (error, message, deadline s)
FAILURES = {"fail_on_rank_1": (RuntimeError, "rank 1 fails on purpose", 60.0),
            "hang_on_rank_1": (TimeoutError, "did not finish", 10.0)}


@pytest.mark.parametrize("fn", list(FAILURES))
def test_failing_rank_fails_the_run(tmp_path, fn):
    """A rank that raises fails run_ranks at once with its traceback (its
    peer, waiting in a collective, is stopped); a rank that hangs fails it
    at the deadline. Every process is gone afterwards."""
    import multiprocessing

    err, match, deadline = FAILURES[fn]
    t0 = time.monotonic()
    with pytest.raises(err, match=match):
        shard.run_ranks(getattr(C, fn), 2, device="cpu",
                        init_method=f"file://{tmp_path / 'store'}",
                        timeout_s=TIMEOUT_S, deadline_s=deadline, threads=1)
    assert time.monotonic() - t0 < deadline + 15
    assert not multiprocessing.active_children()


def test_group_of_one_and_backend_rules():
    """Without a process group a RankGroup of one, whose collectives are
    the identity; the nccl backend without a card raises; a block that
    does not split over the ranks raises."""
    g = shard.make_group("cpu")
    assert (g.rank, g.size, g.device.type, g.backend) == (0, 1, "cpu", None)
    x = torch.arange(6.0)
    assert shard.all_gather(g, x) is x and shard.ring_shift(g, x) is x
    with pytest.raises(ValueError, match="do not split"):
        shard.rank_block(dataclasses.replace(g, size=4), x)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
        shard.init_process_group(device="cpu", backend="nccl",
                                 init_method="file:///nonexistent/x",
                                 num_processes=1, process_id=0)
