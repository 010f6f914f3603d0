"""``portbench/spans.py`` on the card, briefly: a traced run of each cell
with the recorder on reads every metric of ``spans.EXTRA`` for the cell
beside the cell's own, puts all but under 1% of the device time down to a
launch call, and its ``mega.segment`` device time is the segment
kernel's. Marked
``cuda``; they skip without a card.

    python -m pytest -m cuda portbench/tests/test_pb_spans_card.py -q
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


def _line(err, tag):
    for ln in err.splitlines():
        if ln.startswith(tag):
            return json.loads(ln[len(tag):])
    raise AssertionError(f"no {tag!r} line")


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         ["bunny.render", "showcase.render", "bunny.grad"])
def test_spans_on_card(card, workload):
    from portbench import harness, spans

    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "spans.py"),
         "--workload", workload, "--seed", "3123456789", "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=420)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    cell = harness.find_cell(harness.bench_file(), workload)
    want = {m["name"] for m in cell.per_layer} | {
        n for n, *_, cells in spans.EXTRA if workload in cells}
    assert set(last["metrics"]) == want
    rows = {r[0]: r for r in _line(p.stderr, "spans_by_span: ")}
    device_ms = sum(r[1] for r in rows.values())
    assert rows.get(spans.UNMATCHED, [0, 0])[1] < 0.01 * device_ms
    if workload != "bunny.grad":
        seg = last["metrics"]["segment_ms.render"]["value"]
        assert rows["mega.segment"][1] == pytest.approx(seg, rel=0.01)
