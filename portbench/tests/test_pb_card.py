"""The benchmark's cells on the card, briefly: a run and a traced run of
each, as the benchmark's command makes them. Marked ``cuda``; they skip
without a card.

    python -m pytest -m cuda portbench/tests/test_pb_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from pb_cases import ROOT


@pytest.fixture
def card():
    """Decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload",
                         ["bunny.render", "showcase.render", "bunny.grad"])
def test_cell_on_card(card, workload, trace):
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", workload, "--seed", "987654321", "--seconds", "3",
         "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT,
        timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"
    if trace:
        assert 0 < last["device"]["busy_s"] <= last["device"]["window_s"]
        assert last["breakdown"]["device_ops"]
        from portbench import harness

        cell = harness.find_cell(harness.bench_file(), workload)
        assert set(last["metrics"]) == {m["name"] for m in cell.per_layer}
