"""Scene tables (counterpart of ``offline_raytracer_tpu/scene/types.py``).

Structure-of-arrays dataclasses of tensors, one per primitive kind, with the
same field names, shapes and dtypes as the JAX package's pytrees. Each has
``.to(device)``; nothing here holds a device of its own.
"""

from __future__ import annotations

import dataclasses

import torch


def scene_device(device) -> torch.device:
    """The device a scene entry point builds on ("cuda" by default). Asked
    for CUDA without a card, it raises rather than build on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: scenes are built on the card by default; pass "
            "device=\"cpu\" to build on the CPU")
    return dev


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, TensorTable):
        return x.to(device)
    return x


@dataclasses.dataclass(frozen=True)
class TensorTable:
    """Frozen dataclass of tensors (and nested tables, ints, None)."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


def float_leaves(table) -> list:
    """[(dotted path, tensor)] of every floating-point tensor of a table
    and of the tables nested in it, in field order."""
    out = []
    for f in dataclasses.fields(table):
        x = getattr(table, f.name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            out.append((f.name, x))
        elif isinstance(x, TensorTable):
            out += [(f"{f.name}.{p}", y) for p, y in float_leaves(x)]
    return out


def with_leaves(table, leaves: dict):
    """``table`` with the tensors at the dotted paths of ``leaves``
    replaced (the inverse of ``float_leaves``)."""
    direct, nested = {}, {}
    for path, x in leaves.items():
        head, _, rest = path.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = x
        else:
            direct[head] = x
    for head, sub in nested.items():
        direct[head] = with_leaves(getattr(table, head), sub)
    return dataclasses.replace(table, **direct)


@dataclasses.dataclass(frozen=True)
class Materials(TensorTable):
    diffuse: torch.Tensor       # (M, 3) Kd
    specular: torch.Tensor      # (M, 3) Ks
    spec_exp: torch.Tensor      # (M,)
    transmission: torch.Tensor  # (M, 3) Kt
    ior: torch.Tensor           # (M,)
    emit: torch.Tensor          # (M, 3)
    is_light: torch.Tensor      # (M,) bool


@dataclasses.dataclass(frozen=True)
class Spheres(TensorTable):
    center: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,)
    mat: torch.Tensor     # (N,) int32


@dataclasses.dataclass(frozen=True)
class Boxes(TensorTable):
    bmin: torch.Tensor  # (N, 3)
    bmax: torch.Tensor  # (N, 3)
    mat: torch.Tensor   # (N,) int32


@dataclasses.dataclass(frozen=True)
class Cylinders(TensorTable):
    base: torch.Tensor    # (N, 3)
    axis: torch.Tensor    # (N, 3) non-unit: |axis| = height
    radius: torch.Tensor  # (N,)
    rot: torch.Tensor     # (N, 3, 3) world->local rotation (axis -> +Z)
    mat: torch.Tensor     # (N,) int32


@dataclasses.dataclass(frozen=True)
class Triangles(TensorTable):
    v0: torch.Tensor   # (N, 3)
    v1: torch.Tensor   # (N, 3)
    v2: torch.Tensor   # (N, 3)
    mat: torch.Tensor  # (N,) int32


@dataclasses.dataclass(frozen=True)
class Camera(TensorTable):
    """Pinhole/thin-lens camera; axes pre-scaled as in the JAX package."""

    p: torch.Tensor       # (3,)
    x_axis: torch.Tensor  # (3,)
    y_axis: torch.Tensor  # (3,)
    z_axis: torch.Tensor  # (3,)


@dataclasses.dataclass(frozen=True)
class Sky(TensorTable):
    """The two-colour gradient a ray reaches when it leaves the scene: with
    a = (d.up + 1) / 2 for the unit direction d, (1 - a) bottom + a top."""

    bottom: torch.Tensor  # (3,)
    top: torch.Tensor     # (3,)
    up: torch.Tensor      # (3,) unit


@dataclasses.dataclass(frozen=True)
class Scene(TensorTable):
    materials: Materials
    spheres: Spheres
    boxes: Boxes
    cylinders: Cylinders
    triangles: Triangles
    lights: object            # ops.lights.AreaLights
    camera: Camera
    ambient: torch.Tensor       # (3,)
    mat_to_light: torch.Tensor  # (M,) int32: light index or -1
    tri_bvh: object = None      # ops.bvh.TriBVH or None
    sky: object = None          # Sky, or None: a miss adds nothing

    @property
    def n_lights(self) -> int:
        return self.lights.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.materials.diffuse.device
