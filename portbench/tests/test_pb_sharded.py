"""The ``sharded`` loop's cell (``showcase.sharded4``) on two gloo ranks on
the CPU, cut to a CPU-sized image, mesh and call: whole runs, the control,
the gather check and the readers of ``gather_ms.sharded`` and
``rank_skew_pct.sharded``."""

import io
import json
import time

import pytest

from pb_cases import few_threads, tiny_cell  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.usefixtures("few_threads")
CELL = "showcase.sharded4"
SEED = 4242424242


def _cell():
    cell = tiny_cell(CELL, n_tris=300)
    cell.workload["chips"] = 2
    cell.traffic["samples_per_call"] = 2
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_sharded_run(trace):
    cell = _cell()
    out, err = io.StringIO(), io.StringIO()
    harness.run(cell.name, SEED, 0.5, trace, "cpu", time.perf_counter(),
                cell=cell, out=out, err=err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["correct"] is True and last["attempted"] >= 1
    assert last["checks"]["path_mismatch_pct"]["value"] == 0.0
    assert last["device"]["count"] == 2
    if trace:
        # off the card there is no device trace for the readers
        assert last["metrics"] == {}
    else:
        assert set(last["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in last["metrics"].values())


def test_sharded_control_fails_the_limits():
    from portbench.control import control

    cell = _cell()
    c = control(CELL, 1, 3, "cpu", "bfloat16", cell=cell)
    assert any(c[k] > lim for k, lim in cell.limits.items()), c
    c = control(CELL, 1, 3, "cpu", "float32", cell=cell)
    assert all(c[k] == 0.0 for k in cell.limits)


def _rank(gathers=2, nbytes=24, gather_s=0.004, compute_s=0.1):
    return {"calls": 2, "gathers": gathers, "bytes": nbytes,
            "image_bytes": 12, "gather_s": gather_s, "compute_s": compute_s}


def test_gather_check_and_readers():
    mod = harness.module("loops", "sharded")
    mod.gather_check([_rank(), _rank()], 2)
    with pytest.raises(SystemExit, match="rank 1"):
        mod.gather_check([_rank(), _rank(gathers=3)], 2)
    with pytest.raises(SystemExit, match="rank 0"):
        mod.gather_check([_rank(nbytes=12), _rank()], 2)
    rec = harness.Record(setup_s=1.0, window_s=1.0, attempted=2, spans={},
                         values={"ranks": [_rank(gather_s=0.004),
                                           _rank(gather_s=0.008,
                                                 compute_s=0.08)]})
    assert abs(harness.reader("gather_ms.sharded")(rec) - 3.0) < 1e-12
    assert abs(harness.reader("rank_skew_pct.sharded")(rec) - 20.0) < 1e-9
    none = harness.Record(setup_s=1.0, window_s=1.0, attempted=2, spans={},
                          values={"ranks": [_rank(gather_s=None,
                                                  compute_s=None)] * 2})
    for name in ("gather_ms.sharded", "rank_skew_pct.sharded"):
        assert harness.reader(name)(none) is None
        assert harness.reader(name)(harness.Record(
            setup_s=1.0, window_s=1.0, attempted=1, spans={},
            values={})) is None
