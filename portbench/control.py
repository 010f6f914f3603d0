"""Readings of a cell's control: the reference in the program's place,
with its tables, rays, light samples and carried state held in bfloat16,
compared by the run's own numbers with the float32 reference.

    python3 portbench/control.py --workload bunny.render --seeds 1 2 3 \
        --launches 400
    python3 portbench/control.py --workload bunny.grad --seeds 1 2 3
    python3 portbench/control.py --workload bunny.grad --seeds 1 2 3 \
        --precision float32 --fault altered

For a render cell and each seed it draws the check rows a run of that
seed draws, for ``--launches`` launches (as many as a run makes), and
traces them; for an inverse-rendering cell the reference follows the
checked steps in the program's place, with ``--fault`` planted
(``reference/inverse.py``) if given. One JSON line of the numbers per
seed. ``--precision float32`` without a fault reads 0 on every number.
The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control(workload: str, seed: int, launches: int, device: str,
            precision: str = "bfloat16", cell=None,
            fault: str | None = None) -> dict:
    """The cell's numbers with the reference at ``precision`` in the
    program's place, by the ``control`` of the loop its traffic file names
    (``portbench/loops/<loop>.py``): for a render cell over the check rows
    of ``launches`` launches, for an inverse-rendering cell over its
    checked steps, there with ``fault`` planted if given."""
    from portbench import harness

    cell = cell or harness.find_cell(harness.bench_file(), workload)
    ctx = harness.Ctx(cell, seed, 0.0, False, device, time.perf_counter())
    numbers = harness.loop_module(cell).control(ctx, launches, precision,
                                                fault)
    return {"workload": workload, "seed": seed, "precision": precision,
            "fault": fault, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--launches", type=int, default=0,
                   help="launches whose check rows a render cell compares")
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--fault", choices=("altered", "half"),
                   help="an inverse-rendering cell's planted fault")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: the control runs on the card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        t0 = time.perf_counter()
        out = control(a.workload, seed, a.launches, "cuda", a.precision,
                      fault=a.fault)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
