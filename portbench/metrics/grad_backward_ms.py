"""The backward of a traced step, in ms: ``torch.autograd.grad`` of the
loss through the replay, its gathers' scatter-adds included; a benchmark
span synchronised at both ends, averaged over the traced steps."""


def read(rec):
    xs = rec.values.get("backward_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
