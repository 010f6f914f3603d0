"""The replay forward of a traced step, in ms: the loss, from the scene's
setter through the segment launches with records and the replay
(``replay.replay_paths``) to the mean; a benchmark span synchronised at
both ends, averaged over the traced steps."""


def read(rec):
    xs = rec.values.get("forward_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
