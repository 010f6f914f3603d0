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


def _rle_row(values):
    """New-style RLE of one channel of a scanline: runs of 3 or more equal
    bytes as (128 + n, byte), the rest as literal chunks (n, bytes...)."""
    out, i, n = [], 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += [128 + j - i, int(values[i])]
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and values[k] == values[k + 1] == values[k + 2]):
            k += 1
        out += [k - i] + [int(x) for x in values[i:k]]
        i = k
    return out


@pytest.mark.parametrize("layout", ["flat", "rle"])
def test_read_hdr_matches_jax(tmp_path, layout):
    """Both packages' readers give the same image: of the flat file both
    write (the image's RGBE rounding), and of a new-style RLE file with
    runs, literals and the -Y / -X orientation."""
    rs = np.random.RandomState(4)
    img = (rs.exponential(0.5, (7, 40, 3)) * (rs.uniform(size=(7, 40, 1))
                                               > 0.2)).astype(np.float32)
    img[:, 10:30] = img[:, 10:11]                   # runs along each row
    path = str(tmp_path / f"{layout}.hdr")
    if layout == "flat":
        hdr.write_hdr(path, img)
        want = hdr.rgbe_to_float(hdr.float_to_rgbe(img))
    else:
        rgbe = hdr.float_to_rgbe(img)
        body = []
        for row in rgbe:
            body += [2, 2, 40 >> 8, 40 & 255]
            for c in range(4):
                body += _rle_row(row[:, c])
        with open(path, "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 7 -X 40\n")
            f.write(bytes(body))
        want = hdr.rgbe_to_float(rgbe)[::-1, ::-1]
    got = hdr.read_hdr(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_hdr.read_hdr(path))
