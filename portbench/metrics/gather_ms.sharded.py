"""Device ms per traced 8-sample call of the operations launched inside the
program's ``shard.all_gather`` spans (the NCCL all-gather of the image,
which waits on the device for the slowest rank, and the concatenation),
averaged over the ranks (each rank's profiler trace, ``spans.attribute``;
the spans' ``shard.bytes`` are checked to be the whole image's)."""


def read(rec):
    ranks = rec.values.get("ranks") or []
    ms = [1e3 * t["gather_s"] / t["calls"] for t in ranks
          if t.get("gather_s") is not None and t.get("calls")]
    return sum(ms) / len(ms) if ms else None
