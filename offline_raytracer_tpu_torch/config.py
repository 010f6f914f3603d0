"""Render configuration (counterpart of ``offline_raytracer_tpu/config.py``).

Same fields, defaults and validation as the JAX package's RenderConfig, so a
configuration means the same render in both packages. ``traversal``,
``use_bvh`` and ``use_pallas`` choose the route as in the JAX package
(``render._paths_fn``): "auto"/"mega" take the segment kernel when the
scene fits it, "cull", "packet" and "jnp" the wavefront route with the
cull kernel, the packet kernel or the plain dense sweep for triangles;
``use_pallas=False`` means the plain sweep, ``use_bvh=False`` the brute-
force wavefront. ``grad_mode`` picks how a differentiated render on the
segment route gets its value ("kernel-value": the kernel's radiance with
the replay's gradient; "replay-value": the replay's radiance, see
``replay.py``), and ``replay_tiers`` compacts the replay
(``integrator.trace_paths``). Knobs only the JAX package's TPU code reads
(``mega_trip_leaves``, ``accum_dtype``) are kept for parity and ignored
here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # image
    width: int = 1280
    height: int = 720

    # sampling
    spp: int = 2048
    seed: int = 0
    max_bounces: int = 12
    russian_roulette: float = 0.8  # survival probability per bounce
    rr_start_bounce: int = 0       # bounce index at which RR starts

    # camera / depth of field
    aperture_radius: float = 0.1
    focal_anchor_z: float = 0.2    # focal_length = |cam_p - (0,0,anchor_z)|
    enable_dof: bool = True
    aperture_disk: bool = False    # False = aperture rim (ring bokeh)
    pixel_jitter: bool = True

    # shading
    default_roughness: float = 0.01
    roughness_from_material: bool = False
    enable_nee: bool = True
    enable_mis: bool = True
    # reproduce the reference renderer's uncompensated final Russian-
    # roulette gate on light-terminated paths (see the JAX config)
    reference_rr_quirk: bool = False
    hit_eps: float = 1e-4
    t_min: float = 1e-6

    # acceleration
    use_bvh: bool = True
    bvh_leaf_size: int = 128
    max_stack_depth: int = 64
    sort_rays: bool = True

    # execution
    ray_batch: int = 1 << 17       # rays per launch (pixels*spp chunked)
    mega_trip_leaves: int = 4      # TPU walk knob; unused by the port
    mega_sort_after: int = 3       # coherence-compact the wavefront after
    #                                bounces 0..N-1, then fuse the tail
    replay_tiers: tuple = ()
    use_pallas: bool = True
    traversal: str = "auto"
    grad_mode: str = "kernel-value"
    accum_dtype: str = "float32"

    PERF_ONLY = ("ray_batch", "use_pallas", "traversal", "sort_rays",
                 "max_stack_depth", "mega_trip_leaves", "mega_sort_after",
                 "replay_tiers", "grad_mode")

    def __post_init__(self):
        if self.traversal not in ("auto", "mega", "cull", "packet", "jnp"):
            raise ValueError(
                f"traversal must be one of auto|mega|cull|packet|jnp, "
                f"got {self.traversal!r}")
        if self.grad_mode not in ("kernel-value", "replay-value"):
            raise ValueError(
                f"grad_mode must be kernel-value|replay-value, "
                f"got {self.grad_mode!r}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# the reference renderer's showcase render: its size and spp, its estimator
# (no NEE, no pixel jitter, the uncompensated final RR gate)
REFERENCE_SHOWCASE = RenderConfig(
    width=1280, height=720, spp=2048,
    enable_nee=False, enable_mis=False, pixel_jitter=False,
    reference_rr_quirk=True,
)

