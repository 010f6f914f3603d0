"""Seconds from the process's start to the first timed launch: imports,
kernel build or load, inputs, scene build and warm-up (host clock)."""


def read(rec):
    return rec.setup_s
