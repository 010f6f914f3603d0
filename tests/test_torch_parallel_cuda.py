"""``parallel/`` on the card: the sharded render and the ring, their
kernels' launches counted on each rank.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips without them.
It imports no jax, so it runs on a card machine without jax:
``python -m pytest -m cuda --noconftest tests/test_torch_parallel_cuda.py``.

NCCL takes one rank per card, so several ranks on one card use gloo; the
four-rank NCCL cases need four cards. The scene is a mesh of 71 leaves at
64x64, 2 spp, 4 bounces. Bounds: the sharded image equals the
single-process render of the same pixels (rtol 1e-5 / atol 1e-6, and no
value differs at all), the ring's image the replicated wavefront render
of the same route within rtol 1e-4 / atol 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.parallel import shard
from offline_raytracer_tpu_torch.render import render_block
from offline_raytracer_tpu_torch.utils import hdr

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = C.CARD_CFG


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


@pytest.fixture
def four_cards(device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one NCCL rank each)")
    return 4


def _check(outs, device):
    """Every rank's results against the single-process renders on the
    card, and each rank's launches."""
    n = len(outs)
    sc = C.scene("card", device)
    ids = C.pixel_ids(CFG, device)
    single = render_block(sc, CFG, ids, 0, CFG.spp).cpu().numpy()
    per_sample = len(mega.segment_plan(CFG)[0])
    ring_steps = 2 * n * CFG.max_bounces * CFG.spp
    for o in outs:
        np.testing.assert_array_equal(o["sharded"], outs[0]["sharded"])
        np.testing.assert_allclose(o["sharded"], single, rtol=1e-5, atol=1e-6)
        assert (o["sharded"].view(np.int32) != single.view(np.int32)).sum() == 0
        assert o["sharded_launches"] == (per_sample * CFG.spp, 0, 0)
        assert o["cull_launches"] == (0, ring_steps, 0)
        assert o["packet_launches"] == (0, 0, ring_steps)
    for route in ("cull", "packet"):
        rep = render_block(sc, CFG.replace(traversal=route), ids, 0,
                           CFG.spp).cpu().numpy()
        assert rep.mean() > 0
        for o in outs:
            np.testing.assert_allclose(o[route], rep, rtol=1e-4, atol=1e-5,
                                       err_msg=route)


@pytest.mark.cuda
def test_nccl_one_rank(device):
    _check(shard.run_ranks(C.card_cases, 1, device="cuda", timeout_s=120,
                           deadline_s=600), device)


@pytest.mark.cuda
def test_gloo_two_ranks_on_one_card(device):
    _check(shard.run_ranks(C.card_cases, 2, device="cuda", backend="gloo",
                           timeout_s=120, deadline_s=600), device)


@pytest.mark.cuda
def test_nccl_four_ranks(device, four_cards):
    _check(shard.run_ranks(C.card_cases, four_cards, device="cuda",
                           timeout_s=120, deadline_s=600), device)


@pytest.mark.cuda
def test_torchrun_multihost_cli(device, tmp_path):
    """``torchrun --nproc-per-node N -m offline_raytracer_tpu_torch.cli
    --multihost``, one NCCL rank per card (at most 4): rank 0 writes the
    non-sharded command line's image and prints the JSON line."""
    from offline_raytracer_tpu_torch import cli

    n = min(torch.cuda.device_count(), 4)
    flags = ["--preset", "analytic", "--width", "32", "--height", "32",
             "--spp", "2", "--max-bounces", "4", "--no-dof"]
    assert cli.main(flags + ["--out", str(tmp_path / "one.hdr")]) == 0
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-port", str(shard.free_port()), "-m",
         "offline_raytracer_tpu_torch.cli", "--multihost", *flags, "--out",
         str(tmp_path / "multi.hdr")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["width"] == 32
    np.testing.assert_array_equal(hdr.read_hdr(str(tmp_path / "multi.hdr")),
                                  hdr.read_hdr(str(tmp_path / "one.hdr")))
