"""Percent of the wavefront bounces' lanes over the traced launches that
carried a live ray: the program's counters ``wave.live`` (lanes live on
entry to a bounce) over ``wave.lanes`` (lanes each bounce runs)."""


def read(rec):
    program = getattr(rec.trace, "program", None)
    if not program:
        return None
    c = program["counters"]
    if not c.get("wave.lanes"):
        return None
    return 100.0 * c.get("wave.live", 0) / c["wave.lanes"]
