"""Rays of a launch, from the integrator's per-bounce alive counts.

Frozen copy of the arithmetic of ``offline_raytracer_tpu_torch/utils/
profiling.RenderMeter.add_launch`` at commit 7999567 (last changed in
675aaa9), which ``chip_smoke.py`` phase 4 and ``bench.py:153-160`` count
alike: every path has a camera segment and one more per bounce it
survives, and with NEE one shadow ray per shading point (the camera hit
and every surviving bounce but the last). Summed in float64, so the count
stays exact past 2**24 rays.
"""

import numpy as np


def launch_rays(n_paths: int, alive_per_bounce, nee: bool) -> float:
    """Rays of one launch of ``n_paths`` paths with alive counts (B,)."""
    alive = np.asarray(alive_per_bounce, np.float64).reshape(-1)
    segments = float(n_paths) + float(alive.sum())
    shadow = float(n_paths) + float(alive[:-1].sum()) if nee else 0.0
    return segments + shadow
