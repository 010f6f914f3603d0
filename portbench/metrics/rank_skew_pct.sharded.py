"""The ranks' skew over the traced calls, in percent: the spread of the
ranks' device time outside the ``shard.all_gather`` spans (each rank's own
block's render), (slowest - fastest) / slowest, from each rank's profiler
trace. The all-gather makes the faster ranks wait for the slowest."""


def read(rec):
    ranks = rec.values.get("ranks") or []
    work = [t["compute_s"] for t in ranks if t.get("compute_s") is not None]
    if len(work) < 2 or max(work) <= 0:
        return None
    return 100.0 * (max(work) - min(work)) / max(work)
