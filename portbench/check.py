"""The comparison that decides ``correct``.

Each loop hands over the numbers it compared the program's outputs by; a
cell's limits file (``portbench/limits/<workload>.json``) gives the limit
of each, set in ``PERF.md`` from the readings of sound runs of the program
(the lower) and of the control (the upper). A run is correct when every
number is at or under its limit.

Render launches: the program's radiance of a sample of (pixel, sample)
paths drawn from the seed, against the reference's radiance of the same
paths, and the program's alive counts of every launch against the
reference's alive share on the sample.

- ``path_mismatch_pct``: the share of compared paths, in percent, whose
  radiance differs from the reference's in some channel by more than
  ``RTOL`` of the reference's plus ``ATOL``. A path that takes another
  turn (a hit decided the other way by rounding, a tie between two
  triangles at one truncated distance) differs by far more; a path that
  takes the same turns agrees to float32 rounding, far inside ``RTOL``.
- ``alive_z``: over the bounces, the largest distance between the
  program's alive share (all rays of all launches of the window) and the
  reference's share on the sample, in standard errors of a sample of that
  size drawn from the program's share.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RTOL = 1e-3
ATOL = 1e-5


def path_mismatch_pct(prog, ref) -> float:
    """Percent of rows of (N, 3) radiance that differ beyond tolerance."""
    prog = prog.to(ref.device, torch.float32)
    bad = (torch.abs(prog - ref) > ATOL + RTOL * torch.abs(ref)).any(-1)
    bad = bad | ~torch.isfinite(prog).all(-1)
    return 100.0 * float(bad.float().mean())


def alive_z(prog_share, ref_alive) -> float:
    """prog_share: (B,) alive shares of the window's launches; ref_alive:
    (B, N) bool of the sampled paths. The standard error is the sample's
    under the program's share (the share of every path of the window),
    with a floor of one path in N."""
    n = ref_alive.shape[1]
    worst = 0.0
    for b in range(ref_alive.shape[0]):
        f = float(prog_share[b])
        g = float(ref_alive[b].float().mean())
        se = math.sqrt(f * (1.0 - f) / n + 1.0 / (n * n))
        worst = max(worst, abs(f - g) / se)
    return worst


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median leaf's
    norm)} over ``leaves``."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].float()))
             for k in leaves}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(
                prog[k].to(ref[k].device).float())) - norms[k])
            / max(norms[k], med, 1e-30) for k in leaves}


def training_numbers(losses, first, after, start, ref) -> dict:
    """Inverse-rendering steps against the reference's, over the first
    steps: ``loss_gap``, the largest relative gap of a step's loss;
    ``grad_gap``, by the worst leaf, the gap of the first gradient's norm
    (as Adam got it) against the reference's norm of that leaf or of the
    median leaf, whichever is larger; ``change_gap``, likewise, of the
    parameters' change over the steps. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref["losses"]))
    grads = _leaf_gaps(first, ref["first_grads"], list(first))
    gnorm = {k: float(torch.linalg.vector_norm(v))
             for k, v in ref["first_grads"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in after if gnorm[k] >= 1e-3 * med]
    change = _leaf_gaps(
        {k: after[k] - start[k] for k in moved},
        {k: ref["params"][k] - start[k].to(ref["params"][k].device)
         for k in moved}, moved) if moved else {}
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "change_gap": max(change.values()) if change else 0.0}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number the loop compared."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise SystemExit(f"no limit for {missing} in the cell's limits file")
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()}
