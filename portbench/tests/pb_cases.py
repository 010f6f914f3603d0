"""Shared cases of the benchmark's tests: tiny cells on the CPU, and the
few-threads fixture of the CPU runs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(workload: str, width=16, height=16, n_tris=512):
    """The cell as BENCHMARK.json names it, cut to a CPU-sized image and
    mesh; every other setting as committed."""
    from portbench import harness

    cell = harness.find_cell(harness.bench_file(), workload)
    cell.config["render"].update(width=width, height=height)
    for e in cell.config["scene"]:
        if "mesh" in e:
            e["mesh"]["n_tris"] = n_tris
    return cell


@pytest.fixture
def few_threads():
    """At most 4 torch threads for a test (the CPU runs share a machine)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
