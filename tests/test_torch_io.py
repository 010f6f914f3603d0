"""Port's PLY loader, bunny preset, frame math and HDR/PNG writers vs the
JAX package."""

import numpy as np
import pytest
import torch

from offline_raytracer_tpu.models import scenes as jax_scenes
from offline_raytracer_tpu.scene.ply import load_ply as jax_load_ply
from offline_raytracer_tpu.utils import hdr as jax_hdr
from offline_raytracer_tpu.utils import math as jax_math
from offline_raytracer_tpu_torch.models import scenes
from offline_raytracer_tpu_torch.scene.ply import load_ply
from offline_raytracer_tpu_torch.utils import hdr
from offline_raytracer_tpu_torch.utils import math as tmath
from torch_port_cases import jax_scene_arrays, port_leaf, procedural_mesh

torch.set_num_threads(2)


def _write_ply(path, v, faces, extra_props=0):
    lines = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
             "property float x", "property float y", "property float z"]
    lines += [f"property float c{k}" for k in range(extra_props)]
    lines += [f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(f"{x:.6f}" for x in row) + " 0.5" * extra_props
              for row in v]
    lines += [" ".join(str(x) for x in [len(f), *f]) for f in faces]
    path.write_text("\n".join(lines) + "\n")


def test_load_ply_matches_jax(tmp_path):
    """Extra vertex properties skipped; quads and pentagons fanned."""
    rs = np.random.RandomState(0)
    v = rs.uniform(-1, 1, (12, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7, 8, 9], [9, 10, 11]]
    path = tmp_path / "mesh.ply"
    _write_ply(path, v, faces, extra_props=2)
    got_v, got_f = load_ply(str(path))
    want_v, want_f = jax_load_ply(str(path))
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    assert got_f.shape == (1 + 2 + 3 + 1, 3)


def test_bunny_preset_matches_jax(tmp_path):
    """bunny() on a stand-in bunny.ply builds the JAX preset's scene."""
    v, f = procedural_mesh(700)
    _write_ply(tmp_path / "bunny.ply", v * 0.075, f.tolist())
    js = jax_scenes.bunny(32, 32, data_dir=str(tmp_path))
    ts = scenes.bunny(32, 32, data_dir=str(tmp_path), device="cpu")
    for path, want in jax_scene_arrays(js).items():
        got = port_leaf(ts, path)
        if path.startswith(".tri_bvh.") and path.split(".")[-1] in (
                "planes", "child_rows"):
            continue   # native-builder allowance (tests/test_torch_scene.py)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_to_world_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n = rs.standard_normal((500, 3)).astype(np.float32)
    n[:50] = [0.0, 0.0, 1.0]                      # pole branch
    n[50:100] = [0.0, 0.0, -1.0]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    local = rs.standard_normal((500, 3)).astype(np.float32)
    want = np.asarray(jax_math.frame_to_world(local, n))
    got = tmath.frame_to_world(torch.from_numpy(local), torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    axis = rs.standard_normal(3)
    np.testing.assert_array_equal(tmath.rotation_matrix_to_z(axis),
                                  jax_math.rotation_matrix_to_z(axis))


def test_hdr_and_png_bytes_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    img = (rs.exponential(0.5, (9, 13, 3)) * (rs.uniform(size=(9, 13, 1))
                                               > 0.1)).astype(np.float32)
    for writer, jax_writer, name, arg in (
            (hdr.write_hdr, jax_hdr.write_hdr, "x.hdr", img),
            (hdr.write_png, jax_hdr.write_png, "x.png", hdr.tonemap(img))):
        writer(str(tmp_path / ("port_" + name)), arg)
        jax_writer(str(tmp_path / ("jax_" + name)), arg)
        assert ((tmp_path / ("port_" + name)).read_bytes()
                == (tmp_path / ("jax_" + name)).read_bytes())
    np.testing.assert_array_equal(hdr.tonemap(img, 2.0), jax_hdr.tonemap(img, 2.0))
