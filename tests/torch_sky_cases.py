"""Cases of the sky tests that the parent commit's port runs too: renders of
scenes without a sky through every route, with the ATen operations each
issued, so that ``tests/golden/no_sky_routes.npz`` (made by this module's
``main`` from a checkout of the commit before the sky) pins the outputs
and operation counts of sky-less scenes bitwise. The forward wavefront
routes' counts (``brute``, ``brute_rr_mis_off``, ``cull``) were taken
again when their bounce stopped masking the material index of its
parameter gather, 3 operations a bounce fewer, with every output
unchanged; every route's count again when ``lights.sample_lights``
rotated its cylinder samples elementwise in place of an einsum (8
operations fewer a call) and the segment loop took a segment's light
planes in one concatenation (2 fewer a segment), with every output
unchanged.

    python tests/torch_sky_cases.py <checkout> <out.npz>

imports ``offline_raytracer_tpu_torch`` from ``<checkout>`` and writes the
cases' outputs there. No jax import."""

from __future__ import annotations

import collections
import sys

import numpy as np

R = 200          # not a multiple of the segment block: pad lanes too


def _crowd(B, n=130):
    """More spheres than the segment kernel's tables hold, a floor and a
    sphere light."""
    rs = np.random.RandomState(0)
    b = B()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_material(diffuse=(0.6, 0.3, 0.2), specular=(0.2, 0.2, 0.2),
                   spec_exp=30.0)
    for _ in range(n):
        b.add_sphere(rs.uniform((-1.5, -1.5, 0.1), (1.5, 1.5, 1.2)), 0.08)
    b.add_material(specular=(0.04, 0.04, 0.04),
                   transmission=(0.9, 0.9, 0.9), ior=1.5)
    b.add_sphere((0.0, 0.0, 0.6), 0.5)
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    half = np.pi / 4
    b.set_camera((3.0, 0.0, 1.0), 0.5,
                 np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32))
    return b


def _mesh(B):
    """A diffuse floor, a procedural mesh and a sphere light: the segment
    route's shapes."""
    rs = np.random.RandomState(1)
    b = B()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_material(diffuse=(0.3, 0.6, 0.4), specular=(0.3, 0.3, 0.3),
                   spec_exp=40.0)
    v = rs.uniform((-1.0, -1.0, 0.0), (1.0, 1.0, 1.5), (60, 3))
    f = rs.randint(0, 60, (100, 3))
    b.add_triangles(v.astype(np.float32), f)
    b.add_light_material((6.0, 6.0, 6.0))
    b.add_sphere((1.0, -1.0, 3.0), 0.5)
    half = np.pi / 4
    b.set_camera((3.0, 0.0, 1.0), 0.5,
                 np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32))
    return b


class _OpCounter:
    """Counts the ATen operations issued inside it, by name."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counts[str(func.overloadpacket)] += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def cases() -> dict:
    """{name: (numpy arrays of the outputs, ATen operations issued)} of
    sky-less renders through each route on the CPU with one thread."""
    import torch

    from offline_raytracer_tpu_torch import RenderConfig, diff
    from offline_raytracer_tpu_torch.render import render_block_stats
    from offline_raytracer_tpu_torch.scene.build import SceneBuilder

    torch.set_num_threads(1)
    base = dict(width=16, height=16, spp=1, max_bounces=4, enable_dof=True,
                aperture_disk=True, seed=11)
    ids = torch.arange(R, dtype=torch.int32)
    crowd = _crowd(SceneBuilder).build(16, 16, device="cpu")
    mesh = _mesh(SceneBuilder).build(16, 16, device="cpu")
    out = {}
    runs = {
        "brute": (crowd, RenderConfig(use_bvh=False, **base)),
        "brute_rr_mis_off": (crowd, RenderConfig(
            use_bvh=False, enable_mis=False, russian_roulette=0.7,
            roughness_from_material=True, **base)),
        "cull": (mesh, RenderConfig(traversal="cull", **base)),
        "segment": (mesh, RenderConfig(**base)),
    }
    for name, (scene, cfg) in runs.items():
        with torch.no_grad(), _OpCounter() as c:
            rad, alive = render_block_stats(scene, cfg, ids, 3, 1)
        out[name] = ({"radiance": rad.numpy(), "alive": alive.numpy()},
                     sum(c.counts.values()))
    cfg = RenderConfig(grad_mode="replay-value", **base)
    params = {"diffuse": mesh.materials.diffuse.clone().requires_grad_(True),
              "emit": mesh.materials.emit.clone().requires_grad_(True)}
    target = torch.full((R, 3), 0.25)
    with _OpCounter() as c:
        loss = diff.make_loss_fn(mesh, cfg, target, ids)(params, 5)
        g = torch.autograd.grad(loss, [params["diffuse"], params["emit"]])
    out["replay_grad"] = ({"loss": loss.detach().numpy(),
                           "d_diffuse": g[0].numpy(), "d_emit": g[1].numpy()},
                          sum(c.counts.values()))
    return out


def flat(got: dict) -> dict:
    """The cases as one flat {key: array} (the golden file's layout)."""
    arrays = {}
    for name, (outs, n_ops) in got.items():
        for k, v in outs.items():
            arrays[f"{name}.{k}"] = np.asarray(v)
        arrays[f"{name}.ops"] = np.asarray(n_ops, np.int64)
    return arrays


def main(argv) -> int:
    checkout, path = argv
    sys.path.insert(0, checkout)
    import offline_raytracer_tpu_torch

    print(offline_raytracer_tpu_torch.__file__)
    np.savez(path, **flat(cases()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
