"""Shared cases for the PyTorch port's tests (not collected by pytest).

Each scene recipe takes a SceneBuilder class and makes the same calls on
it, so the JAX package's builder and the port's builder describe one scene.
The comparisons hand data across as numpy arrays. The module imports jax
only inside the functions that run the JAX package, so ``chip_smoke.py``
and the card's tests import it on a machine without jax.
"""

import numpy as np


def assert_close(ref, got, atol=2e-4):
    """tests/test_mega.py::_assert_close, without importing jax."""
    d = np.abs(ref - got)
    rel = d / np.maximum(np.abs(ref), 1e-2)
    assert d.max() < 0.3, f"max abs diff {d.max()}"
    assert (rel > 1e-3).mean() < 0.002, f"rel > 1e-3 share {(rel > 1e-3).mean()}"
    assert abs(ref.mean() - got.mean()) < atol, (
        f"mean diff {abs(ref.mean() - got.mean())}")
    signed = (got - ref).reshape(-1, 3).mean(0)
    assert np.abs(signed).max() < 1e-4, f"signed channel bias {signed}"


def procedural_mesh(n_tris: int, seed: int = 0):
    """A bumpy closed sphere cut to exactly ``n_tris`` triangles:
    (vertices (V, 3) float32, faces (F, 3) int32), unit-ish radius."""
    nv = max(4, int(np.sqrt(n_tris / 4.0)) + 2)
    nu = max(3, -(-n_tris // (2 * (nv - 1))))
    rs = np.random.RandomState(seed)
    th = np.linspace(0.0, np.pi, nv + 1)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    r = 1.0 + 0.08 * rs.standard_normal((th.size, nu))
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)) * r,
                     np.outer(np.sin(th), np.sin(ph)) * r,
                     np.outer(np.cos(th), np.ones(nu)) * r], -1).reshape(-1, 3)
    v = np.concatenate([ring, [[0, 0, 1.0]], [[0, 0, -1.0]]]).astype(
        np.float32)
    top, bot = ring.shape[0], ring.shape[0] + 1
    f = []
    for j in range(nu):
        f.append([top, j, (j + 1) % nu])
    for i in range(th.size - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = a + nu, b + nu
            f += [[a, c, b], [b, c, d]]
    last = (th.size - 1) * nu
    for j in range(nu):
        f.append([bot, last + (j + 1) % nu, last + j])
    f = np.asarray(f, np.int32)
    if f.shape[0] < n_tris:
        raise ValueError("mesh generator made too few triangles")
    return v, f[:n_tris]


# a .scn of every keyword: the mesh "standin.ply" recentred on the floor
# (scale 0.6, z rotation and a quaternion), the small "tile.obj", a glass
# sphere (brdf with the transmission block), a box floor, a cylinder and a
# sphere light, seen by the bunny preset's camera
SCN_TEXT = """\
screen 512 512
camera 2.5 0 0.8 b 0.4 q 0.70710678 0 0.70710678 0
ambient 0.02 0.02 0.03
light 10 10 10
sphere 1.5 -1.5 3.0 0.4
brdf 0.4 0.4 0.45 0 0 0 1
box -10 -10 -0.2 20 20 0.2
brdf 0.6 0.5 0.4 0.3 0.3 0.3 50
mesh standin.ply 0 0 0.6 0.6 z 30 q 0.96592583 0 0 0.25881905
brdf 0.05 0.05 0.05 0.1 0.1 0.1 80 0.9 0.95 0.9 1.5
sphere -0.3 0.9 0.35 0.3
brdf 0.2 0.4 0.7 0 0 0 1
cylinder 0.2 -1.0 0 0 0 0.8 0.15
brdf 0.7 0.3 0.2 0.2 0.2 0.2 20
mesh tile.obj -0.6 -0.9 0.0 0.5 q 1 0 0 0
"""

# a square pyramid: its base a quad, its sides in the v/vt/vn and v//vn
# face formats
OBJ_TEXT = """\
# pyramid
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
v 0 0 1.2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 -1
vn 0 -0.77 0.64
vn 0.77 0 0.64
vn 0 0.77 0.64
vn -0.77 0 0.64
f 4/4/1 3/3/1 2/2/1 1/1/1
f 1/1/2 2/2/2 5/3/2
f 2//3 3//3 5//3
f 3/3/4 4/4/4 -1/1/4
f 4 1 5
"""


def write_ply(path, v, f):
    """An ASCII PLY of vertices (V, 3) and triangles (F, 3); the vertices
    in 9 significant digits, so float32 reads back exactly."""
    f = np.asarray(f)
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(f)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
        np.savetxt(fh, np.asarray(v, np.float32), fmt="%.9g")
        np.savetxt(fh, np.concatenate([np.full((len(f), 1), 3), f], 1),
                   fmt="%d")


def write_scene_files(directory, v, f):
    """SCN_TEXT as scene.scn in ``directory``, with ``v``, ``f`` as its
    standin.ply and OBJ_TEXT as its tile.obj; -> the .scn's path."""
    import os

    write_ply(os.path.join(directory, "standin.ply"), v, f)
    with open(os.path.join(directory, "tile.obj"), "w") as fh:
        fh.write(OBJ_TEXT)
    path = os.path.join(directory, "scene.scn")
    with open(path, "w") as fh:
        fh.write(SCN_TEXT)
    return path


def analytic_recipe(B):
    """Sphere + floor box + one sphere light (tests/conftest.py)."""
    b = B()
    b.add_material(diffuse=(0.7, 0.3, 0.2))
    b.add_sphere((0.0, 0.0, 1.0), 0.8)
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-20, -20, -0.2), (20, 20, 0.0))
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((2.0, -2.0, 4.0), 0.5)
    half = np.pi / 4
    b.set_camera((4.0, 0.0, 1.5), 0.4,
                 np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32))
    return b


def shaped_recipe(B, sphere_light=False):
    """Cylinders, a box light and a cylinder light (tests/test_mega.py
    _shaped_scene), optionally with a sphere light too."""
    b = B()
    b.set_camera((0.0, -3.0, 1.2), 0.5, (0.0, 0.0, 0.0, 1.0))
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-4, -4, -0.2), (4, 4, 0.0))
    b.add_material(diffuse=(0.5, 0.3, 0.2), specular=(0.4, 0.4, 0.4),
                   spec_exp=40)
    b.add_cylinder((-0.8, 0.0, 0.0), (0.0, 0.0, 1.2), 0.3)
    b.add_cylinder((0.2, -0.5, 0.4), (1.0, 0.5, 0.0), 0.2)
    b.add_material(diffuse=(0.2, 0.4, 0.7))
    b.add_sphere((0.9, 0.6, 0.35), 0.35)
    b.add_light_material((6.0, 5.0, 4.0))
    b.add_box_minmax((-0.5, -0.5, 2.4), (0.5, 0.5, 2.6))
    b.add_light_material((2.0, 3.0, 4.0))
    b.add_cylinder((2.0, 2.0, 0.0), (0.0, 0.0, 2.0), 0.15)
    if sphere_light:
        b.add_light_material((9.0, 9.0, 7.0))
        b.add_sphere((-1.5, 1.0, 2.0), 0.3)
    return b


def light_kinds_recipe(B, kinds="scm"):
    """A floor and one light of each kind named in ``kinds``, in that
    order: "s" a sphere, "c" a tilted cylinder (its rotation is no
    permutation), "m" a mesh (an emissive box: 12 triangles); each light
    its own emission."""
    b = B()
    b.set_camera((0.0, -4.0, 1.5), 0.5, (0.0, 0.0, 0.0, 1.0))
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-5, -5, -0.2), (5, 5, 0.0))
    for k in kinds:
        if k == "s":
            b.add_light_material((9.0, 9.0, 7.0))
            b.add_sphere((-1.5, 1.0, 2.0), 0.3)
        elif k == "c":
            b.add_light_material((2.0, 3.0, 4.0))
            b.add_cylinder((0.6, -0.4, 0.5), (0.5, 0.7, 1.3), 0.2)
        else:
            b.add_light_material((6.0, 5.0, 4.0))
            b.add_box_minmax((-0.5, -0.3, 2.4), (0.7, 0.5, 2.6))
    return b


def mesh_recipe(B, n_tris=576):
    """The bunny configuration (materials, floor, light, camera) around a
    procedural mesh of ``n_tris`` triangles, plus a glass sphere."""
    v, f = procedural_mesh(n_tris)
    v = (v - v.mean(0)) * 0.6
    v[:, 2] -= v[:, 2].min()
    b = B()
    b.add_material(diffuse=(0.6, 0.5, 0.4), specular=(0.3, 0.3, 0.3),
                   spec_exp=50)
    b.add_triangles(v, f)
    b.add_material(diffuse=(0.4, 0.4, 0.45))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_material(specular=(0.1, 0.1, 0.1), transmission=(0.9, 0.95, 0.9),
                   ior=1.5)
    b.add_sphere((-0.2, 0.9, 0.35), 0.3)
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    half = np.pi / 4
    b.set_camera((2.5, 0.0, 0.8), 0.4,
                 np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32))
    return b


def jax_scene_arrays(scene) -> dict:
    """{keystr path: np.ndarray} of a JAX Scene's pytree leaves."""
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def port_leaf(scene, path: str):
    """The port scene's tensor at a keystr path, as numpy."""
    x = scene
    for part in path.lstrip(".").split("."):
        x = getattr(x, part)
    return x.detach().cpu().numpy()


def assert_scenes_equal(js, ts):
    """A JAX scene and the port's build of the same calls: every leaf of
    equal dtype and shape and equal values, but for the BVH arrays the JAX
    side may build with its native builder (planes within rtol 2e-5, child
    rows' lanes 0-11 within rtol 1e-6, empty-subtree sentinels inf or
    1e30)."""
    arrays = jax_scene_arrays(js)
    assert arrays, "no leaves"
    for path, want in arrays.items():
        got = port_leaf(ts, path)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if path not in (".tri_bvh.planes", ".tri_bvh.child_rows"):
            np.testing.assert_array_equal(got, want, err_msg=path)
    if js.tri_bvh is not None:
        jb, tb = js.tri_bvh, ts.tri_bvh
        assert (tb.n_leaves, tb.m_occ) == (jb.n_leaves, jb.m_occ)
        np.testing.assert_allclose(tb.planes.numpy(), np.asarray(jb.planes),
                                   rtol=2e-5, atol=1e-5)
        c_j = np.asarray(jb.child_rows)[:, :12]
        c_t = tb.child_rows.numpy()[:, :12]
        big = np.abs(c_j) > 1e29
        np.testing.assert_allclose(c_t[~big], c_j[~big], rtol=1e-6)
        assert (np.abs(c_t[big]) > 1e29).all()


def mega_case(recipe, R, **cfg_kw):
    """One bounce-loop comparison: the same rays and keys through the JAX
    megakernel (interpret mode, records), the JAX integrator (alive
    counts) and the port's render_paths_mega on the CPU (plain version),
    the port fed the JAX scene through scene_from_arrays."""
    import jax.numpy as jnp
    import torch

    from offline_raytracer_tpu.config import RenderConfig as JaxConfig
    from offline_raytracer_tpu.integrator import trace_paths
    from offline_raytracer_tpu.ops import mega as jax_mega
    from offline_raytracer_tpu.ops.camera import generate_rays
    from offline_raytracer_tpu.render import _trace_builder
    from offline_raytracer_tpu.scene.build import SceneBuilder
    from offline_raytracer_tpu.utils import rng as jax_rng
    from offline_raytracer_tpu_torch.config import RenderConfig
    from offline_raytracer_tpu_torch.convert import scene_from_arrays
    from offline_raytracer_tpu_torch.ops import mega
    from offline_raytracer_tpu_torch.utils import rng

    base = dict(width=64, height=64, spp=1, max_bounces=4, enable_dof=False)
    base.update(cfg_kw)
    jcfg = JaxConfig(traversal="jnp", **base)
    scene = recipe(SceneBuilder).build(64, 64)
    ids = np.arange(R, dtype=np.int32) % (64 * 64)
    keys = jax_rng.pixel_sample_keys(
        jax_rng.render_key(jcfg.seed), jnp.asarray(ids),
        jnp.zeros((R,), jnp.int32))
    ro, rd = generate_rays(scene.camera, jcfg, jnp.asarray(ids), keys)
    rad, hit_ids, vis = jax_mega.render_paths_mega(
        scene, jcfg, ro, rd, keys, interpret=True, collect_records=True)
    trace_fn, occl_fn = _trace_builder(scene, jcfg)
    _, counts = trace_paths(scene, jcfg, trace_fn, ro, rd, keys,
                            collect_stats=True, occl_fn=occl_fn)

    tscene = scene_from_arrays(jax_scene_arrays(scene), device="cpu")
    tkeys = rng.pixel_sample_keys(
        rng.render_key(base.get("seed", 0)), torch.from_numpy(ids),
        torch.zeros((R,), dtype=torch.int32))
    out = mega.render_paths_mega(
        tscene, RenderConfig(**base), torch.from_numpy(np.array(ro)),
        torch.from_numpy(np.array(rd)), tkeys, collect_records=True)
    return {
        "ref": (np.asarray(rad), np.asarray(hit_ids), np.asarray(vis),
                np.asarray(counts)),
        "got": tuple(x.numpy() for x in out),
    }


def check_mega(case, budget=0.002):
    """Records equal on live lanes up to ``budget`` of them (edge ties after
    the t truncation), alive counts within the mismatches, radiance within
    tests/test_mega.py's bounds."""
    from test_mega import _assert_close

    rad, ids, vis, counts = case["ref"]
    t_rad, t_ids, t_vis, t_alive = case["got"]
    R = rad.shape[0]
    assert t_ids.shape == ids.shape and t_ids.dtype == np.int32
    live = np.concatenate([np.ones((1, R), bool), t_alive[:-1] > 0.5], 0)
    differ = ((ids != t_ids) | (vis != t_vis)) & live
    assert differ.sum() <= budget * live.sum(), (
        f"{differ.sum()} of {live.sum()} live records differ")
    assert np.abs(t_alive.sum(1) - counts).max() <= differ.sum(), (
        t_alive.sum(1), counts)
    _assert_close(rad, t_rad)


def port_bvh(bvh, verts=None):
    """The port's TriBVH holding a JAX TriBVH's arrays; with the triangles'
    ``verts`` (v0, v1, v2) also the sub-boxes the port's builder adds."""
    import torch

    from offline_raytracer_tpu_torch.ops.bvh import TriBVH, sub_bounds_rows

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    sub = (None if verts is None
           else t(sub_bounds_rows(np.array(bvh.tri_index), *verts)))
    return TriBVH(child_rows=t(bvh.child_rows), planes=t(bvh.planes),
                  tri_index=t(bvh.tri_index), mat=t(bvh.mat),
                  leaf_bounds=t(bvh.leaf_bounds), sub_bounds=sub,
                  n_leaves=bvh.n_leaves, m_occ=bvh.m_occ)


def random_tris(n, seed=0, spread=4.0):
    """tests/test_bvh.py::_random_tris."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    a = rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    b = rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    return c, c + a, c + b


def random_rays(R, seed, spread=6.0, targets=None):
    """Random origins in a cube; random unit directions, or with
    ``targets`` (K, 3) every other ray aimed at a random target."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-spread, spread, (R, 3)).astype(np.float32)
    rd = rs.randn(R, 3).astype(np.float32)
    if targets is not None:
        k = rs.randint(0, targets.shape[0], R)
        rd[::2] = (targets[k] - ro)[::2]
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


FAR = 2e7       # origin height of far_origin_rays


def far_origin_recipe(B):
    """A triangle 2e6 across at z = -10 under 300 small random triangles
    near the origin, one sphere light: the scene of far_origin_rays."""
    b = B()
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_triangles(np.array([[-1e6, -1e6, -10.0], [1e6, -1e6, -10.0],
                              [0.0, 1e6, -10.0]], np.float32), [[0, 1, 2]])
    v0, v1, v2 = random_tris(300, seed=3)
    b.add_triangles(np.concatenate([v0, v1, v2]),
                    np.arange(900, dtype=np.int32).reshape(3, 300).T)
    b.add_light_material((5.0, 5.0, 5.0))
    b.add_sphere((0.0, 0.0, 40.0), 2.0)
    b.set_camera((0.0, 0.0, 20.0), 0.5, (0.0, 0.0, 0.0, 1.0))
    return b


def far_origin_rays(R=64):
    """R rays from FAR above the big triangle of far_origin_recipe, away
    from the small ones, nearly straight down; every 4th points up (a
    miss). -> (ro, rd) (R, 3) float32."""
    rs = np.random.RandomState(0)
    ro = np.concatenate([rs.uniform(-2e5, 2e5, (R, 2)),
                         np.full((R, 1), FAR)], 1).astype(np.float32)
    rd = np.concatenate([rs.uniform(-1e-3, 1e-3, (R, 2)),
                         -np.ones((R, 1))], 1)
    rd[::4, 2] = 1.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def wavefront_case(recipe, R, traversal="cull", **cfg_kw):
    """The same rays and keys through the JAX integrator's trace_paths on
    the CPU (its jnp BVH walk) and the port's wavefront on the CPU (the
    plain sweep behind the cull/packet wrappers), the port fed the JAX
    scene through scene_from_arrays. -> {"ref": (radiance, alive counts),
    "got": (...)} as numpy."""
    import jax.numpy as jnp
    import torch

    from offline_raytracer_tpu.config import RenderConfig as JaxConfig
    from offline_raytracer_tpu.integrator import trace_paths as jax_trace
    from offline_raytracer_tpu.ops.camera import generate_rays
    from offline_raytracer_tpu.render import _trace_builder as jax_builder
    from offline_raytracer_tpu.scene.build import SceneBuilder
    from offline_raytracer_tpu.utils import rng as jax_rng
    from offline_raytracer_tpu_torch.config import RenderConfig
    from offline_raytracer_tpu_torch.convert import scene_from_arrays
    from offline_raytracer_tpu_torch.integrator import trace_paths
    from offline_raytracer_tpu_torch.render import _trace_builder
    from offline_raytracer_tpu_torch.utils import rng

    base = dict(width=64, height=64, spp=1, max_bounces=4, enable_dof=False)
    base.update(cfg_kw)
    jcfg = JaxConfig(traversal="jnp", **base)
    scene = recipe(SceneBuilder).build(64, 64)
    ids = np.arange(R, dtype=np.int32) % (64 * 64)
    keys = jax_rng.pixel_sample_keys(
        jax_rng.render_key(jcfg.seed), jnp.asarray(ids),
        jnp.zeros((R,), jnp.int32))
    ro, rd = generate_rays(scene.camera, jcfg, jnp.asarray(ids), keys)
    trace_fn, occl_fn = jax_builder(scene, jcfg)
    rad, counts = jax_trace(scene, jcfg, trace_fn, ro, rd, keys,
                            collect_stats=True, occl_fn=occl_fn)

    tscene = scene_from_arrays(jax_scene_arrays(scene), device="cpu")
    cfg = RenderConfig(traversal=traversal, **base)
    tkeys = rng.pixel_sample_keys(
        rng.render_key(cfg.seed), torch.from_numpy(ids),
        torch.zeros((R,), dtype=torch.int32))
    t_trace, t_occl = _trace_builder(tscene, cfg)
    t_rad, t_counts = trace_paths(
        tscene, cfg, t_trace, torch.from_numpy(np.array(ro)),
        torch.from_numpy(np.array(rd)), tkeys, collect_stats=True,
        occl_fn=t_occl)
    return {"ref": (np.asarray(rad), np.asarray(counts)),
            "got": (t_rad.numpy(), t_counts.numpy())}


def replay_case(recipe, R, records=True, **cfg_kw):
    """R camera rays of a recipe's scene with (if ``records``) the JAX
    megakernel's records (interpret mode), and the same scene, config,
    rays and keys for the port: {"jcfg", "cfg", "js", "ts", "keys",
    "tkeys", "ro", "rd", "ids",
    "vis", "rad", "t_ro", "t_rd", "t_ids", "t_vis"}: the JAX side's arrays
    and the port's tensors (``t_*``: the same values as tensors)."""
    import jax.numpy as jnp
    import torch

    from offline_raytracer_tpu.config import RenderConfig as JaxConfig
    from offline_raytracer_tpu.ops import mega as jax_mega
    from offline_raytracer_tpu.ops.camera import generate_rays
    from offline_raytracer_tpu.scene.build import SceneBuilder
    from offline_raytracer_tpu.utils import rng as jax_rng
    from offline_raytracer_tpu_torch.config import RenderConfig
    from offline_raytracer_tpu_torch.convert import scene_from_arrays
    from offline_raytracer_tpu_torch.utils import rng

    base = dict(width=64, height=64, spp=1, max_bounces=4, enable_dof=False)
    base.update(cfg_kw)
    jcfg = JaxConfig(traversal="jnp", **base)
    js = recipe(SceneBuilder).build(64, 64)
    ids = np.arange(R, dtype=np.int32) * 5 % (64 * 64)
    keys = jax_rng.pixel_sample_keys(
        jax_rng.render_key(jcfg.seed), jnp.asarray(ids),
        jnp.zeros((R,), jnp.int32))
    ro, rd = generate_rays(js.camera, jcfg, jnp.asarray(ids), keys)
    tkeys = rng.pixel_sample_keys(rng.render_key(jcfg.seed),
                                  torch.from_numpy(ids),
                                  torch.zeros((R,), dtype=torch.int32))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    c = dict(jcfg=jcfg, cfg=RenderConfig(**base), js=js,
             ts=scene_from_arrays(jax_scene_arrays(js), device="cpu"),
             keys=keys,
             tkeys=tkeys, ro=ro, rd=rd, t_ro=t(ro), t_rd=t(rd))
    if records:
        rad, hit_ids, vis = jax_mega.render_paths_mega(
            js, jcfg, ro, rd, keys, interpret=True, collect_records=True)
        c.update(ids=hit_ids, vis=vis, rad=np.asarray(rad),
                 t_ids=t(hit_ids), t_vis=t(vis))
    return c


def check_hit_helpers(c):
    """hit_from_ids, and prefetch_hit_params + hit_from_params, vs the JAX
    functions on a replay_case's recorded winner ids: the same ops in the
    same order, so t and the normal agree to float32 rounding (rtol 1e-5,
    atol 1e-6) and the rest exactly."""
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.ops import intersect as jax_isect
    from offline_raytracer_tpu_torch.ops import intersect

    js, ts, t_min = c["js"], c["ts"], c["jcfg"].t_min

    def check(ref, got):
        for f in ("t", "normal"):
            np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        for f in ("mat", "inner", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)

    check(jax_isect.hit_from_ids(js, c["ro"], c["rd"], c["ids"][0], t_min),
          intersect.hit_from_ids(ts, c["t_ro"], c["t_rd"], c["t_ids"][0],
                                 t_min))
    j_hp = jax_isect.prefetch_hit_params(js, jnp.asarray(c["ids"]))
    t_hp = intersect.prefetch_hit_params(ts, c["t_ids"])
    assert sorted(j_hp) == sorted(t_hp)
    for k in j_hp:
        np.testing.assert_array_equal(t_hp[k].detach().numpy(),
                                      np.asarray(j_hp[k]), err_msg=k)
    check(jax_isect.hit_from_params(js, jax.tree.map(lambda x: x[0], j_hp),
                                    c["ro"], c["rd"], t_min),
          intersect.hit_from_params({k: v[0] for k, v in t_hp.items()},
                                    c["t_ro"], c["t_rd"], t_min))


def check_replay(c, **cfg_kw):
    """trace_paths(replay=the JAX records) on both sides, with ``cfg_kw``
    changed in both configs: equal alive counts, radiance within
    assert_close."""
    import jax

    from offline_raytracer_tpu.integrator import trace_paths as jax_trace
    from offline_raytracer_tpu_torch.integrator import trace_paths

    jcfg, cfg = c["jcfg"].replace(**cfg_kw), c["cfg"].replace(**cfg_kw)
    rad, counts = jax.jit(lambda s, ro, rd, k, i, v: jax_trace(
        s, jcfg, None, ro, rd, k, collect_stats=True, replay=(i, v)))(
        c["js"], c["ro"], c["rd"], c["keys"], c["ids"], c["vis"])
    t_rad, t_counts = trace_paths(
        c["ts"], cfg, None, c["t_ro"], c["t_rd"], c["tkeys"],
        collect_stats=True, replay=(c["t_ids"], c["t_vis"]))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(counts))
    assert counts[0] > 0 and rad.mean() > 0
    assert_close(np.asarray(rad), t_rad.numpy())
