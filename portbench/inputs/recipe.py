"""Scene recipes: a configuration's ``scene`` list as builder calls.

A configuration file (``portbench/configs/<name>.json``) describes its
scene as data: an ordered list of entries, each one call on a scene
builder, with "current material = last declared" semantics. ``calls``
turns the list into concrete calls with raw numpy arrays, once; ``apply``
makes them on any builder with the port's method names. The program's
``SceneBuilder`` and the reference's ``reference.scene.SceneArrays`` are
both fed the same calls, so both sides start from the same raw arrays.

Entries:

- ``{"material": {"diffuse": rgb, "specular": rgb, "spec_exp": x,
  "transmission": rgb, "ior": x}}`` (keys optional);
- ``{"light": rgb}``: an emissive material; the shapes that follow are
  lights;
- ``{"sphere": {"center": xyz, "radius": r}}``;
- ``{"box": {"min": xyz, "max": xyz}}``;
- ``{"cylinder": {"base": xyz, "axis": xyz, "radius": r}}`` (|axis| is the
  height);
- ``{"mesh": {"generator": "procedural_mesh", "n_tris": n, "seed": s,
  "scale": k, "fit": f, "translate": xyz}}``: the generator's mesh times
  ``scale``; with ``fit``, recentred on its mean, scaled by ``fit`` and set
  on z = 0 (the bunny preset's placement); then moved by ``translate``.
"""

import numpy as np

from portbench.inputs.procedural_mesh import procedural_mesh

GENERATORS = {"procedural_mesh": procedural_mesh}


def mesh_arrays(spec: dict):
    """(vertices (V, 3) float32, faces (F, 3) int32) of a mesh entry."""
    gen = GENERATORS[spec["generator"]]
    v, f = gen(int(spec["n_tris"]), int(spec.get("seed", 0)))
    v = v * spec.get("scale", 1.0)
    if "fit" in spec:
        v = (np.asarray(v, np.float32) - v.mean(0)) * spec["fit"]
        v[:, 2] -= v[:, 2].min()
    if "translate" in spec:
        v = v + np.asarray(spec["translate"], np.float32)
    return np.asarray(v, np.float32), f


def calls(scene: list) -> list:
    """[(method name, args)] for a recipe's entries, meshes made here."""
    out = []
    for entry in scene:
        if len(entry) != 1:
            raise ValueError(f"a scene entry has one key: {entry}")
        (kind, spec), = entry.items()
        if kind == "material":
            out.append(("add_material", (
                tuple(spec.get("diffuse", (0, 0, 0))),
                tuple(spec.get("specular", (0, 0, 0))),
                float(spec.get("spec_exp", 1.0)),
                tuple(spec.get("transmission", (0, 0, 0))),
                float(spec.get("ior", 1.0)))))
        elif kind == "light":
            out.append(("add_light_material", (tuple(spec),)))
        elif kind == "sphere":
            out.append(("add_sphere", (tuple(spec["center"]),
                                       float(spec["radius"]))))
        elif kind == "box":
            out.append(("add_box_minmax", (tuple(spec["min"]),
                                           tuple(spec["max"]))))
        elif kind == "cylinder":
            out.append(("add_cylinder", (tuple(spec["base"]),
                                         tuple(spec["axis"]),
                                         float(spec["radius"]))))
        elif kind == "mesh":
            out.append(("add_triangles", mesh_arrays(spec)))
        else:
            raise ValueError(f"unknown scene entry {kind!r}")
    return out


def apply(builder, made: list, camera: dict):
    """Make the calls and set the camera on ``builder``; returns it."""
    for name, args in made:
        getattr(builder, name)(*args)
    builder.set_camera(tuple(camera["p"]), float(camera["height_ratio"]),
                       np.asarray(camera["quat_xyzw"], np.float32))
    return builder


def counts(made: list) -> dict:
    """Primitive counts of a recipe's calls (for the tests and PERF.md)."""
    n = {"materials": 1, "spheres": 0, "boxes": 0, "cylinders": 0,
         "triangles": 0, "lights": 0}
    light = False
    for name, args in made:
        if name in ("add_material", "add_light_material"):
            n["materials"] += 1
            light = name == "add_light_material"
        elif name == "add_triangles":
            n["triangles"] += args[1].shape[0]
            n["lights"] += light
        else:
            n[{"add_sphere": "spheres", "add_box_minmax": "boxes",
               "add_cylinder": "cylinders"}[name]] += 1
            n["lights"] += light
    return n


def tile_pixel_ids(width: int, height: int, tile: int = 32) -> np.ndarray:
    """All pixel ids in 32x32-tile-major order, the order in which the
    port's ``render_image`` launches them (frozen copy of ``render.
    tile_pixel_ids`` at commit 7999567)."""
    ids = np.arange(width * height, dtype=np.int32)
    x = ids % width
    y = ids // width
    key = (y // tile).astype(np.int64) * (width // tile + 1) + (x // tile)
    return ids[np.argsort(key, kind="stable")]
