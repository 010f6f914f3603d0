"""Port's render driver vs the JAX package's golden image, batch
invariance, and the port standing alone without jax."""

import os
import subprocess
import sys

import numpy as np
import torch

from offline_raytracer_tpu_torch import RenderConfig
from offline_raytracer_tpu_torch.models.scenes import analytic
from offline_raytracer_tpu_torch.ops import mega
from offline_raytracer_tpu_torch.render import (
    render_block, render_block_stats, render_image, tile_pixel_ids)
from test_mega import _assert_close

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "analytic_24x24_16spp.npy")
BASE = dict(width=24, height=24, max_bounces=5, enable_dof=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_analytic():
    """The JAX package's stored render (tests/test_integrator.py)."""
    img = render_image(analytic(24, 24, device="cpu"),
                       RenderConfig(spp=16, seed=7, **BASE))
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape == (24, 24, 3)
    _assert_close(golden.reshape(-1, 3), img.reshape(-1, 3))


def test_render_deterministic_and_batch_invariant():
    scene = analytic(24, 24, device="cpu")
    cfg = RenderConfig(spp=4, **BASE)
    ids = torch.arange(24 * 24, dtype=torch.int32)
    a = render_block(scene, cfg, ids, 0, 4).numpy()
    b = render_block(scene, cfg, ids, 0, 4).numpy()
    np.testing.assert_array_equal(a, b)
    half1 = render_block(scene, cfg, ids[:288], 0, 4).numpy()
    half2 = render_block(scene, cfg, ids[288:], 0, 4).numpy()
    np.testing.assert_allclose(np.concatenate([half1, half2]), a, rtol=1e-6)


def test_render_stats_count_rays():
    scene = analytic(16, 16, device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=3, max_bounces=4,
                       enable_dof=False, ray_batch=2 * 16 * 16)
    ids = torch.from_numpy(tile_pixel_ids(16, 16))
    out, alive = render_block_stats(scene, cfg, ids, 0, 3)
    np.testing.assert_allclose(
        out.numpy(), render_block(scene, cfg, ids, 0, 3).numpy(), rtol=1e-6)
    assert alive.shape == (4,) and alive[0] > alive[-1] >= 0

    # tables built once and passed in give the same launch bit for bit
    tables = mega.prepare_tables(scene, cfg)
    out_t, alive_t = render_block_stats(scene, cfg, ids, 0, 3, tables)
    np.testing.assert_array_equal(out_t.numpy(), out.numpy())
    np.testing.assert_array_equal(alive_t.numpy(), alive.numpy())

    def rays(launches):
        """bench.py's count: camera + surviving bounces + NEE shadow rays."""
        total = 0.0
        for n_paths, a in launches:
            a = a.numpy().astype(np.float64)
            total += n_paths + a.sum() + n_paths + a[:-1].sum()
        return total

    # spp 3 in chunks of 2 (ray_batch): launches of 2 and 1 samples over
    # 256 pixels count the rays of one 3-sample launch
    chunks = [(512, render_block_stats(scene, cfg, ids, 0, 2, tables)[1]),
              (256, render_block_stats(scene, cfg, ids, 2, 1, tables)[1])]
    assert rays(chunks) == rays([(768, alive)])
    img = np.zeros((16 * 16, 3), np.float32)
    img[ids.numpy()] = out.numpy()
    np.testing.assert_allclose(render_image(scene, cfg),
                               img.reshape(16, 16, 3)[::-1], rtol=1e-6)


def test_port_runs_without_jax():
    """The port imports and renders with jax and flax unavailable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['flax'] = None\n"
        "import numpy as np, torch\n"
        "import offline_raytracer_tpu_torch.render as r\n"
        "from offline_raytracer_tpu_torch import RenderConfig\n"
        "from offline_raytracer_tpu_torch.models.scenes import analytic\n"
        "img = r.render_image(analytic(16, 16, device='cpu'), "
        "RenderConfig(width=16, "
        "height=16, spp=2, max_bounces=3, enable_dof=False))\n"
        "assert img.shape == (16, 16, 3) and np.isfinite(img).all()\n"
        "assert img.mean() > 0\n"
        "assert not any(m == 'offline_raytracer_tpu' or m.startswith("
        "('offline_raytracer_tpu.', 'jax.', 'flax.')) for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_import_no_jax():
    pkg = os.path.join(REPO, "offline_raytracer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for bad in ("import jax", "from jax", "import flax",
                            "from flax", "import offline_raytracer_tpu\n",
                            "from offline_raytracer_tpu.",
                            "import offline_raytracer_tpu."):
                    assert bad not in text, (name, bad)
