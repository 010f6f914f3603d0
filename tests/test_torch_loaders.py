"""The port's .obj and .scn loaders and its mesh presets vs the JAX
package's.

The parser cases take the inline text of the JAX package's data-free
parser tests (``tests/test_parsers.py``) through both packages. Where the
JAX ``load_obj`` parses through its native g++ module, its float parsing
and the port's pure-Python ``float()`` both round the decimal to the
nearest float32, so the arrays are compared exactly. A .scn of every
keyword, with a .ply and an .obj beside it, loads to equal scenes in both
packages (``torch_port_cases.assert_scenes_equal``). The letter, dwarf and
testscene presets need the reference data and skip without it, as the JAX
package's tests do.
"""

import numpy as np
import pytest

from offline_raytracer_tpu.models import scenes as jax_scenes
from offline_raytracer_tpu.scene import obj as jax_obj
from offline_raytracer_tpu.scene import scn as jax_scn
from offline_raytracer_tpu_torch.models import scenes
from offline_raytracer_tpu_torch.scene import obj, scn
from torch_port_cases import (
    OBJ_TEXT, SCN_TEXT, assert_scenes_equal, procedural_mesh,
    write_scene_files)

OBJ_CASES = {
    # tests/test_parsers.py::test_obj_face_formats
    "face_formats": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                     "vn 0 0 1\nvt 0 0\n"
                     "f 1 2 3\n"
                     "f 1//1 2//1 4//1\n"
                     "f 1/1/1 2/1/1 3/1/1 4/1/1\n"),
    "pyramid": OBJ_TEXT,
    "positions_only": ("# comment\nv 0.1 0.2 0.3\nv 1.5 -2 0\nv 0 1e-3 7\n"
                       "v 3 3 3\nf -4 -3 -2 -1\n"),
}

SCN_CASES = {
    # tests/test_parsers.py::test_parse_scn_camera_and_materials
    "camera_and_materials": ("screen 400 300\n"
                             "camera 1 2 3 b 0.2 q 0.5 0.1 0.2 0.3\n"
                             "ambient 0.1 0.1 0.1\n"
                             "brdf 0.9 0.8 0.7 0.1 0.2 0.3 10 0.4 0.5 0.6 1.4\n"
                             "sphere 0 0 1 0.5\n"
                             "light 4 4 4\n"
                             "sphere 2 2 2 0.25\n"),
    # tests/test_parsers.py::test_parse_scn_mesh_tokens
    "mesh_tokens": ("light 4 4 4\n"
                    "mesh bunny.ply  -0.5 0.8 0.23 5.0  z -90 q 0 0 0.707107 "
                    "0.707106\n"
                    "brdf 1 1 1 0 0 0 10 0 0 0 1.0\n"
                    "mesh thing.obj 0 0 0 1.0 q 1 0 0 0\n"),
    "every_keyword": SCN_TEXT,
}


@pytest.mark.parametrize("name", list(OBJ_CASES))
def test_load_obj_matches_jax(tmp_path, name):
    """Equal arrays. A face corner that names no normal or texcoord gets
    index 0 in the port, as in the JAX native parser; the JAX pure-Python
    path gives it the count, out of range (ROADMAP C), so the index arrays
    are compared where the JAX index is in range, and the port's must be
    in range everywhere."""
    p = tmp_path / "t.obj"
    p.write_text(OBJ_CASES[name])
    want, got = jax_obj.load_obj(str(p)), obj.load_obj(str(p))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in ("normal_indices", "texcoord_indices"):
            n = got[k.split("_")[0] + "s"].shape[0]
            assert ((g >= 0) & (g < n)).all(), k
            ok = w < n
            np.testing.assert_array_equal(g[ok], w[ok], err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if name == "face_formats":        # the JAX test's own assertions
        assert got["indices"].shape == (4, 3)
        np.testing.assert_array_equal(got["indices"][3], [0, 2, 3])


def _mesh_infos_equal(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.path, g.scale, g.z_degree, g.mat) == (
            w.path, w.scale, w.z_degree, w.mat)
        np.testing.assert_array_equal(g.translate, w.translate)
        np.testing.assert_array_equal(g.quaternion, w.quaternion)
        assert g.quaternion.dtype == w.quaternion.dtype


@pytest.mark.parametrize("name", list(SCN_CASES))
def test_parse_scn_matches_jax(name):
    jb, jm, jsize = jax_scn.parse_scn(SCN_CASES[name])
    tb, tm, tsize = scn.parse_scn(SCN_CASES[name])
    assert tsize == jsize
    _mesh_infos_equal(jm, tm)
    for attr in ("camera_p", "camera_quat", "ambient"):
        np.testing.assert_array_equal(getattr(tb, attr), getattr(jb, attr))
    assert tb.camera_height_ratio == jb.camera_height_ratio
    assert tb.current_mat == jb.current_mat
    if name == "camera_and_materials":
        assert_scenes_equal(jb.build(64, 64), tb.build(64, 64, device="cpu"))


def test_parse_scn_refuses_bad_text():
    with pytest.raises(ValueError, match="unknown keyword"):
        scn.parse_scn("screen 4 4\nteapot 1 2 3\n")
    with pytest.raises(ValueError, match="expected 'q'"):
        scn.parse_scn("camera 1 2 3 b 0.2 w 0.5 0.1 0.2 0.3\n")


@pytest.mark.parametrize("zdeg,quat", [(90.0, (0, 0, 0, 1.0)),
                                       (-37.5, (0.1, 0.7, -0.2, 0.68))])
def test_transform_mesh_vertices_matches_jax(zdeg, quat):
    """tests/test_parsers.py::test_transform_mesh_vertices_order's case and
    a general one."""
    kw = dict(path="x", translate=np.array([1.0, 2.0, 3.0], np.float32),
              scale=2.0, z_degree=zdeg,
              quaternion=np.array(quat, np.float32), mat=0)
    v = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    v[0] = (1.0, 0.0, 0.0)
    want = jax_scn.transform_mesh_vertices(v, jax_scn.MeshInfo(**kw))
    got = scn.transform_mesh_vertices(v, scn.MeshInfo(**kw))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if zdeg == 90.0:
        np.testing.assert_allclose(got[0], [1.0, 2.0, 1.0], atol=1e-3)


def test_load_scene_matches_jax(tmp_path):
    """A .scn of every keyword with a .ply and an .obj mesh: equal scenes
    and sizes; the width and height arguments win over ``screen``."""
    v, f = procedural_mesh(600)
    path = write_scene_files(str(tmp_path), v, f)
    js, jsize = jax_scn.load_scene(path)
    ts, tsize = scn.load_scene(path, device="cpu")
    assert tsize == jsize == (512, 512)
    assert ts.triangles.mat.shape[0] == 600 + 6
    assert ts.device.type == "cpu"
    assert_scenes_equal(js, ts)
    _, size = scn.load_scene(path, 64, 48, device="cpu")
    assert size == (64, 48)


def test_load_scene_refuses_other_mesh_formats(tmp_path):
    (tmp_path / "m.x").write_text("")
    p = tmp_path / "s.scn"
    p.write_text("brdf 1 1 1 0 0 0 1\nmesh m.x 0 0 0 1 q 1 0 0 0\n")
    with pytest.raises(ValueError, match="unsupported mesh format"):
        scn.load_scene(str(p), device="cpu")


def test_presets_by_name_and_size():
    """The port has the JAX package's presets by the same names, and then
    its own procedural ``spd_tetra``; ``preset`` builds one at its own
    default size."""
    assert list(scenes.BY_NAME) == list(jax_scenes.BY_NAME) + ["spd_tetra"]
    scene, size = scenes.preset("analytic", device="cpu")
    assert size == (256, 256)
    assert_scenes_equal(jax_scenes.analytic(), scene)
    _, size = scenes.preset("analytic", 32, None, device="cpu")
    assert size == (32, 256)
    _, size = scenes.preset("spd_tetra", 32, None, device="cpu")
    assert size == (32, 512)


@pytest.mark.parametrize("name", ["letter", "dwarf", "testscene"])
def test_data_presets_match_jax(ref_data_dir, name):
    js = jax_scenes.BY_NAME[name](data_dir=ref_data_dir)
    ts = scenes.BY_NAME[name](data_dir=ref_data_dir, device="cpu")
    assert_scenes_equal(js, ts)
    if name == "testscene":     # the file's own screen size
        _, size = scenes.testscene(data_dir=ref_data_dir, device="cpu",
                                   with_size=True)
        assert size == (400, 300)
