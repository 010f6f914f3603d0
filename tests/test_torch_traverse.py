"""The wavefront route's building blocks against the JAX package: bounce
uniforms (bitwise), intersection, BSDF and light pdfs, the dense leaf cull,
and the plain triangle sweep against the JAX cull and packet kernels in
interpret mode; and what the traversal kernels' wrappers prepare on the
host: their tables, the cull kernel's conservative row cull (against the
JAX lists and the dense sweep) and the lanes-per-ray rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.ops import bsdf as jax_bsdf
from offline_raytracer_tpu.ops import intersect as jax_I
from offline_raytracer_tpu.ops import lights as jax_lights
from offline_raytracer_tpu.ops.bvh import build_tri_bvh
from offline_raytracer_tpu.scene.build import SceneBuilder
from offline_raytracer_tpu.utils import rng as jax_rng
from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.ops import bsdf, intersect, lights
from offline_raytracer_tpu_torch.ops import traverse, traverse_cull
from offline_raytracer_tpu_torch.utils import rng
from torch_port_cases import (
    jax_scene_arrays, mesh_recipe, port_bvh, random_rays, random_tris,
    shaped_recipe)

torch.set_num_threads(2)

# float32 results of the same formulas in the same order; XLA may still
# reassociate a 3-term sum or contract to an FMA, hence the rtol of 1e-5
# to 1e-4 below rather than bit equality
T_MIN = 1e-6
T = torch.from_numpy


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    """{name: (jax scene, port scene)} for a scene of spheres, boxes and
    cylinders and one of 576 triangles."""
    out = {}
    for name, recipe in (("shaped", shaped_recipe), ("mesh", mesh_recipe)):
        js = recipe(SceneBuilder).build(32, 32)
        ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
        out[name] = (js, ts)
    return out


def _scene_rays(R, seed):
    ro, rd = random_rays(R, seed, spread=3.0)
    ro[:, 2] = np.abs(ro[:, 2]) + 0.5
    return ro, rd


def test_bounce_uniforms_bitwise():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 1 << 20, 500).astype(np.int32)
    smp = rs.randint(0, 64, 500).astype(np.int32)
    jk = jax_rng.pixel_sample_keys(jax_rng.render_key(5), jnp.asarray(ids),
                                   jnp.asarray(smp))
    tk = rng.pixel_sample_keys(rng.render_key(5), T(ids), T(smp))
    for b in (0, 3, 11):
        np.testing.assert_array_equal(
            rng.bounce_uniforms(tk, b, 8).numpy(),
            _np(jax_rng.bounce_uniforms(jk, b, 8)))


@pytest.mark.parametrize("kind", ["sphere", "box", "cylinder", "triangle"])
def test_all_pairs_ts_match_jax(scenes, kind):
    name = "mesh" if kind == "triangle" else "shaped"
    js, ts = scenes[name]
    table = {"sphere": "spheres", "box": "boxes", "cylinder": "cylinders",
             "triangle": "triangles"}[kind]
    ro, rd = _scene_rays(96, seed=1)
    ref = _np(getattr(jax_I, f"{kind}_ts")(
        getattr(js, table), jnp.asarray(ro), jnp.asarray(rd), T_MIN))
    got = getattr(intersect, f"{kind}_ts")(
        getattr(ts, table), T(ro), T(rd), T_MIN).numpy()
    hit = np.isfinite(ref)
    assert hit.any()
    np.testing.assert_array_equal(np.isfinite(got), hit)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["shaped", "mesh"])
def test_closest_hit_and_refine_match_jax(scenes, name):
    """closest_hit_bruteforce: the all-pairs search, then refine_hit's
    differentiable recompute of t, normal, material and inner."""
    js, ts = scenes[name]
    ro, rd = _scene_rays(128, seed=2)
    ref = jax_I.closest_hit_bruteforce(js, jnp.asarray(ro), jnp.asarray(rd),
                                       T_MIN)
    got = intersect.closest_hit_bruteforce(ts, T(ro), T(rd), T_MIN)
    valid = _np(ref.valid)
    assert valid.mean() > 0.2
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.mat.numpy(), _np(ref.mat))
    np.testing.assert_array_equal(got.inner.numpy(), _np(ref.inner))
    np.testing.assert_allclose(got.t.numpy()[valid], _np(ref.t)[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.normal.numpy(), _np(ref.normal),
                               rtol=1e-4, atol=1e-5)


def _bsdf_inputs(n, seed):
    rs = np.random.RandomState(seed)

    def unit(k):
        v = rs.randn(k, 3)
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    mat = dict(kd=rs.uniform(0, 0.8, (n, 3)), ks=rs.uniform(0, 0.5, (n, 3)),
               kt=rs.uniform(0, 1, (n, 3)) * (rs.rand(n, 1) < 0.4),
               ior=rs.uniform(1.0, 2.0, n), roughness=rs.uniform(0.05, 0.8, n))
    mat = {k: v.astype(np.float32) for k, v in mat.items()}
    return (unit(n), unit(n), unit(n), mat,
            rs.uniform(0, 3, n).astype(np.float32),
            rs.uniform(0, 1, (n, 3)).astype(np.float32))


def test_bsdf_eval_pdf_sample_match_jax():
    """Tolerance: GGX values span decades, so rtol 1e-4 with atol 1e-5."""
    n_, wi, wo, mat, dist, u = _bsdf_inputs(2000, seed=4)
    jm = jax_bsdf.MatParams(**{k: jnp.asarray(v) for k, v in mat.items()})
    tm = bsdf.MatParams(**{k: T(v) for k, v in mat.items()})
    J, P = jnp.asarray, T
    np.testing.assert_allclose(
        bsdf.eval_bsdf(P(n_), P(wi), P(wo), tm, P(dist)).numpy(),
        _np(jax_bsdf.eval_bsdf(J(n_), J(wi), J(wo), jm, J(dist))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        bsdf.pdf_bsdf(P(n_), P(wi), P(wo), tm).numpy(),
        _np(jax_bsdf.pdf_bsdf(J(n_), J(wi), J(wo), jm)), rtol=1e-4,
        atol=1e-5)
    ref = jax_bsdf.sample_bsdf(J(u), J(n_), J(wo), jm)
    got = bsdf.sample_bsdf(P(u), P(n_), P(wo), tm)
    np.testing.assert_array_equal(got.is_transmission.numpy(),
                                  _np(ref.is_transmission))
    np.testing.assert_allclose(got.wi.numpy(), _np(ref.wi), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("from_material", [False, True])
def test_gather_mat_params_matches_jax(scenes, from_material):
    js, ts = scenes["mesh"]
    idx = np.array([0, 1, 2, 3, 4, 2, 1], np.int32)
    ref = jax_bsdf.gather_mat_params(js.materials, jnp.asarray(idx), 0.01,
                                     from_material)
    got = bsdf.gather_mat_params(ts.materials, T(idx), 0.01, from_material)
    for f in ("kd", "ks", "kt", "ior", "roughness"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(ref, f)), rtol=1e-6)


def test_light_pdfs_match_jax(scenes):
    js, ts = scenes["shaped"]
    rs = np.random.RandomState(6)
    li = rs.randint(-1, 3, 50).astype(np.int32)
    np.testing.assert_allclose(
        lights.light_pdf_area(ts.lights, T(li)).numpy(),
        _np(jax_lights.light_pdf_area(js.lights, jnp.asarray(li))),
        rtol=1e-6)
    pa, dist, cos = (rs.uniform(0.01, 2, 50).astype(np.float32),
                     rs.uniform(0.1, 5, 50).astype(np.float32),
                     rs.uniform(-1, 1, 50).astype(np.float32))
    np.testing.assert_allclose(
        lights.solid_angle_pdf(T(pa), T(dist), T(cos)).numpy(),
        _np(jax_lights.solid_angle_pdf(jnp.asarray(pa), jnp.asarray(dist),
                                       jnp.asarray(cos))), rtol=1e-6)
    np.testing.assert_allclose(
        lights.mis_balance(T(pa), T(dist)).numpy(),
        _np(jax_lights.mis_balance(jnp.asarray(pa), jnp.asarray(dist))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# triangle queries
# ---------------------------------------------------------------------------


def _bvh(n, seed, edit=None):
    """(JAX TriBVH, the port's TriTables of the same arrays, centroids);
    ``edit(v0, v1, v2)`` may change the random triangles first."""
    v0, v1, v2 = random_tris(n, seed=seed)
    if edit is not None:
        edit(v0, v1, v2)
    jb = build_tri_bvh(v0, v1, v2, np.zeros(n, np.int32))
    return (jb, traverse.tri_tables(port_bvh(jb, (v0, v1, v2))),
            (v0 + v1 + v2) / 3)


def _mesh_tables(name):
    """(port scene, its TriTables) of a scene with triangles."""
    from offline_raytracer_tpu_torch.models.scenes import bunny_builder
    from offline_raytracer_tpu_torch.scene.build import (
        SceneBuilder as PortBuilder)
    from torch_port_cases import procedural_mesh

    if name == "mesh":
        scene = mesh_recipe(PortBuilder).build(16, 16, device="cpu")
    else:
        v, f = procedural_mesh(3000)
        scene = bunny_builder(v * 0.075, f).build(16, 16, device="cpu")
    return scene, traverse.tri_tables(scene.tri_bvh)


@pytest.mark.parametrize("name", ["mesh", "bunny-like"])
def test_kernel_tables_are_the_segment_kernels(name):
    """The traversal kernels' leaf-major table and sub-boxes are, bit for
    bit, what mega.prepare_tables builds from the same BVH, and the
    leaf-major table maps back to every slot's coefficient row."""
    from offline_raytracer_tpu_torch import RenderConfig
    from offline_raytracer_tpu_torch.ops import bvh as tbvh
    from offline_raytracer_tpu_torch.ops import mega

    scene, tables = _mesh_tables(name)
    mt = mega.prepare_tables(scene, RenderConfig(enable_dof=False))
    assert torch.equal(tables.tri_lm, mt.tri_lm)
    assert torch.equal(tables.sub, mt.sub)
    assert torch.equal(tables.sub[..., :6], scene.tri_bvh.sub_bounds)
    S = tables.tri.shape[0]
    assert tables.sub.shape == (S // tbvh.LEAF, tbvh.SUB, 8)
    flat = tables.tri_lm.reshape(-1, 4)
    s = torch.arange(S)
    for plane, cols in ((0, slice(8, 12)), (1, slice(0, 4)),
                        (2, slice(4, 8))):
        got = flat[((s // tbvh.LEAF) * 3 + plane) * tbvh.LEAF
                   + s % tbvh.LEAF]
        assert torch.equal(got, tables.tri[:, cols])


def test_tables_without_sub_boxes_serve_only_the_plain_sweep():
    jb, _, c = _bvh(300, seed=4)
    tables = traverse.tri_tables(port_bvh(jb))
    assert tables.sub is None
    ro, rd = random_rays(64, seed=1, targets=c)
    assert (traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)[1]
            >= 0).any()


@pytest.mark.parametrize("rays_per_row", [128, 32, 4])
def test_row_cull_is_a_superset_of_the_jax_lists(rays_per_row):
    """The kernel's conservative row cull wants every leaf the JAX
    package's exact cull lists for a 128-ray row (its rows of 128 /
    rays_per_row kernel rows together), with shadow bounds and dead
    lanes."""
    from offline_raytracer_tpu.ops.traverse_cull import block_leaf_lists

    jb, tables, c = _bvh(700, seed=21)       # 6 leaves
    ro, rd = random_rays(512, seed=9, targets=c)
    tb = np.random.RandomState(2).uniform(0.0, 12.0, 512).astype(np.float32)
    tb[::9] = 0.0
    ref_l, ref_c = block_leaf_lists(jb, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(tb), 128)
    rows = traverse_cull.row_cull_plain(tables, T(ro), T(rd), T_MIN, T(tb),
                                        rays_per_row).numpy()
    assert rows.shape == (512 // rays_per_row, tables.m_occ)
    per_block = rows.reshape(4, -1, tables.m_occ).any(1)
    ref_l, ref_c = _np(ref_l), _np(ref_c)[:, 0]
    for b in range(4):
        assert per_block[b, ref_l[b, :ref_c[b]]].all()
    assert rows.any(1).all()


def test_row_cull_keeps_a_leaf_the_exact_cull_drops():
    """A ray in the plane of a leaf box's face (0 * inf = NaN in the exact
    slab test) hits a triangle on that face: the JAX package's exact cull
    drops the leaf, the conservative cull keeps it."""
    from offline_raytracer_tpu.ops.traverse_cull import block_leaf_lists

    def edge_on(v0, v1, v2):
        # the lowest edge lies at y = 0, across the ray's path
        v0[0], v1[0], v2[0] = (5, 0, -1), (5, 0, 1), (5, 1, 0)

    jb, tables, _ = _bvh(300, seed=3, edit=edge_on)
    ro = np.zeros((128, 3), np.float32)
    rd = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (128, 1))
    _, s = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)
    leaf = int(s[0]) // 128
    assert int(s[0]) >= 0 and _np(jb.tri_index)[int(s[0])] == 0
    ref_l, ref_c = block_leaf_lists(jb, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.full((128,), jnp.inf), 128)
    assert leaf not in _np(ref_l)[0, :int(_np(ref_c)[0, 0])]
    assert traverse_cull.row_cull_plain(tables, T(ro), T(rd), T_MIN)[0, leaf]


def _listed_sweep(tables, ro, rd, t_far, any_hit, rays_per_row):
    """The plain sweep of each row's rays over the leaves on its list only
    (the other leaves' coefficients zeroed: n = 0 never hits)."""
    import dataclasses

    rows = traverse_cull.row_cull_plain(tables, ro, rd, T_MIN, t_far,
                                        rays_per_row)
    out = [], []
    for r, listed in enumerate(rows):
        keep = torch.zeros(tables.tri.shape[0] // 128, dtype=torch.bool)
        keep[:tables.m_occ] = listed
        tri = tables.tri * keep.repeat_interleave(128)[:, None]
        part = slice(r * rays_per_row, (r + 1) * rays_per_row)
        got = traverse.tri_hit_plain(
            dataclasses.replace(tables, tri=tri), ro[part], rd[part], T_MIN,
            None if t_far is None else t_far[part], any_hit)
        for acc, x in zip(out, got):
            acc.append(x)
    return tuple(torch.cat(acc) for acc in out)


@pytest.mark.parametrize("name", ["mesh", "bunny-like", "random"])
@pytest.mark.parametrize("rays_per_row", [128, 32, 4])
def test_sweep_of_the_row_lists_equals_the_dense_sweep(name, rays_per_row):
    """Closest and any hit over each row's conservative list equal the
    dense sweep, slots and t bit for bit (the any-hit slot too: the least
    hit slot), on camera-like rays and shadow rays with dead lanes."""
    if name == "random":
        _, tables, c = _bvh(1500, seed=6)
        ro, rd = random_rays(600, seed=5, targets=c)
    else:
        _, tables = _mesh_tables(name)
        ro, rd = random_rays(600, seed=5, spread=3.0)
        ro[:, 2] = np.abs(ro[:, 2]) + 0.5
        rd[::2] = -ro[::2] / np.linalg.norm(ro[::2], axis=1, keepdims=True)
    ro, rd = T(ro), T(rd)
    ro[::50] = 1e8                                  # parked: a miss
    tf = T(np.random.RandomState(1).uniform(0.2, 6.0, 600).astype(
        np.float32))
    tf[::7] = 0.0
    for t_far, any_hit in ((None, False), (tf, True), (tf, False)):
        ref = traverse.tri_hit_plain(tables, ro, rd, T_MIN, t_far, any_hit)
        got = _listed_sweep(tables, ro, rd, t_far, any_hit, rays_per_row)
        assert (ref[1] >= 0).sum() > 20
        assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
        assert (ref[1][::50] == -1).all()


def test_parked_and_dead_rays_miss():
    """The contract's dead rays are those with t_far <= t_min: a finished
    path, parked at the integrator's PARK_ORIGIN and launched with
    t_far = 0, misses in both modes even when it points at a triangle, and
    so does a ray whose bound is t_min. The same rays with a bound hit."""
    from offline_raytracer_tpu_torch.integrator import PARK_ORIGIN

    _, tables, c = _bvh(300, seed=4)
    ro, rd = random_rays(8, seed=1, targets=c)
    for i in (0, 1):
        ro[i] = c[0] + np.array([0, 0, 1], np.float32)
        rd[i] = np.array([0, 0, -1], np.float32)
    ro[2] = np.float32(PARK_ORIGIN)
    rd[2] = -ro[2] / np.linalg.norm(ro[2])
    t, s = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)
    assert int(s[0]) >= 0 and int(s[1]) >= 0
    tf = torch.full((8,), float("inf"))
    tf[0], tf[1], tf[2] = 0.0, T_MIN, 0.0
    assert traverse.live_rays(T(ro), tf, T_MIN).tolist() == (
        [False] * 3 + [True] * 5)
    assert bool(traverse.live_rays(T(ro), None, T_MIN).all())
    for any_hit in (False, True):
        t_b, s_b = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN, tf,
                                          any_hit=any_hit)
        assert (s_b[:3] == -1).all() and torch.isinf(t_b[:3]).all()
        assert torch.equal(s_b[3:] >= 0, s[3:] >= 0)
        if not any_hit:
            assert torch.equal(s_b[3:], s[3:]) and torch.equal(t_b[3:], t[3:])


def test_group_rule():
    """The lanes-per-ray rule of both kernels: a power of two in GROUPS,
    more lanes for fewer rays, the rays' lanes near the aim; 16 for the
    wavefront's 262,144-ray queries (PERF.md)."""
    picks = []
    for n in (1 << 22, 1 << 20, 1 << 19, 1 << 18, 4096, 496, 0):
        g = traverse.group_size(n)
        assert g in traverse.GROUPS and g <= traverse.GROUP_MAX
        assert max(n, 1) * g <= traverse.GROUP_LANES or g == 1
        assert (max(n, 1) * g * 2 > traverse.GROUP_LANES
                or g == traverse.GROUP_MAX)
        picks.append(g)
    assert picks == sorted(picks) and picks[-1] == traverse.GROUP_MAX
    assert picks[:4] == [1, 4, 8, 16]


@pytest.mark.parametrize("kernel", ["cull", "pallas"])
def test_plain_sweep_closest_matches_jax_kernel(kernel):
    """The plain sweep vs the JAX cull / packet kernels (interpret mode),
    R = 160 (not a multiple of a block: padding)."""
    from offline_raytracer_tpu.ops.traverse_cull import bvh_hit_ts_cull
    from offline_raytracer_tpu.ops.traverse_pallas import bvh_hit_ts_pallas

    jb, tables, c = _bvh(200, seed=13 if kernel == "cull" else 9)
    ro, rd = random_rays(160, seed=3 if kernel == "cull" else 2, targets=c)
    fn = bvh_hit_ts_cull if kernel == "cull" else bvh_hit_ts_pallas
    t_ref, s_ref = fn(jb, jnp.asarray(ro), jnp.asarray(rd), T_MIN,
                      interpret=True)
    t_ref, s_ref = _np(t_ref), _np(s_ref)
    t, s = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)
    t, s = t.numpy(), s.numpy()
    hit = np.isfinite(t_ref)
    assert hit.sum() >= 10
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(s >= 0, s_ref >= 0)
    # XLA's CPU code may contract to FMA: t agrees to a few ulps
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    # slots could differ only where two triangles tie exactly in t; these
    # random sets have no such ties
    np.testing.assert_array_equal(s, s_ref)


@pytest.mark.parametrize("kernel", ["cull", "pallas"])
def test_plain_sweep_any_hit_matches_jax_kernel(kernel):
    """Occlusion bits equal the JAX kernels'; dead lanes (t_far = 0)
    never report a hit; R = 200 pads."""
    from offline_raytracer_tpu.ops.traverse_cull import bvh_hit_ts_cull
    from offline_raytracer_tpu.ops.traverse_pallas import bvh_hit_ts_pallas

    jb, tables, c = _bvh(200, seed=17 if kernel == "cull" else 11)
    ro, rd = random_rays(200, seed=8 if kernel == "cull" else 6, targets=c)
    tf = np.random.RandomState(5).uniform(0.5, 12.0, 200).astype(np.float32)
    tf[::5] = 0.0
    fn = bvh_hit_ts_cull if kernel == "cull" else bvh_hit_ts_pallas
    _, s_ref = fn(jb, jnp.asarray(ro), jnp.asarray(rd), T_MIN,
                  jnp.asarray(tf), any_hit=True, interpret=True)
    t, s = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN, T(tf),
                                  any_hit=True)
    occ = s.numpy() >= 0
    np.testing.assert_array_equal(occ, _np(s_ref) >= 0)
    assert occ.any() and not occ[::5].any()
    assert (t.numpy()[occ] == np.float32(T_MIN)).all()


def test_plain_sweep_least_slot_on_ties():
    """Two copies of one triangle in different leaves: the winner is the
    lower slot, whatever order leaves are visited in."""
    v0, v1, v2 = random_tris(130, seed=1)
    v0[129], v1[129], v2[129] = v0[0], v1[0], v2[0]
    jb = build_tri_bvh(v0, v1, v2, np.zeros(130, np.int32))
    tables = traverse.tri_tables(port_bvh(jb))
    c = (v0[0] + v1[0] + v2[0]) / 3
    ro = np.stack([c + [0.0, 0.0, 2.0]]).astype(np.float32)
    rd = np.array([[0.0, 0.0, -1.0]], np.float32)
    t, s = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)
    slots = np.where(_np(jb.tri_index) % 129 == 0)[0]
    assert int(s[0]) == slots.min() and np.isfinite(float(t[0]))


def test_coherence_order_matches_jax():
    from offline_raytracer_tpu.ops.traverse import coherence_order

    jb, tables, c = _bvh(300, seed=4)
    ro, rd = random_rays(256, seed=12, targets=c)
    ro[::7] = 1e8                                   # parked rays
    ref = _np(coherence_order(jb, jnp.asarray(ro), jnp.asarray(rd)))
    got = traverse.coherence_order(tables, T(ro), T(rd)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrappers_on_cpu_take_the_plain_sweep_and_never_the_kernel():
    """CPU tensors go to the plain sweep (the launch counters stay put);
    the kernels' own entry points refuse CPU tensors instead of falling
    back."""
    from offline_raytracer_tpu_torch.ops import traverse_packet

    _, tables, c = _bvh(300, seed=4)
    ro, rd = random_rays(200, seed=1, targets=c)
    ref = traverse.tri_hit_plain(tables, T(ro), T(rd), T_MIN)
    before = (traverse_cull.KERNEL_LAUNCHES, traverse_packet.KERNEL_LAUNCHES)
    for fn in (traverse_cull.bvh_hit_ts_cull,
               traverse_packet.bvh_hit_ts_packet):
        t, s = fn(tables, T(ro), T(rd), T_MIN)
        np.testing.assert_array_equal(s.numpy(), ref[1].numpy())
        np.testing.assert_array_equal(t.numpy(), ref[0].numpy())
    assert (traverse_cull.KERNEL_LAUNCHES,
            traverse_packet.KERNEL_LAUNCHES) == before
    for fn in (traverse_cull.bvh_hit_ts_cull_cuda,
               traverse_packet.bvh_hit_ts_packet_cuda):
        with pytest.raises(ValueError, match="cuda"):
            fn(tables, T(ro), T(rd), T_MIN)
