"""Run one cell of the port's benchmark once, in this process.

    python3 portbench/run.py --workload bunny.render --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout on a machine with the cards the cell asks
for. Prints the card's name, power limit and clocks and each compared
number beside its limit on standard error, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from portbench import harness

    harness.set_cache_dirs()
    cell = harness.find_cell(harness.bench_file(), a.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"FAIL: {a.workload} needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    harness.run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                T_START, cell=cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
