"""Percent of the segment kernel's lanes over the traced launches that
carried a live ray: the program's counters ``mega.live`` (ray-bounces live
on entry) over ``mega.lanes`` (padded rays times each segment's
bounces)."""


def read(rec):
    program = getattr(rec.trace, "program", None)
    if not program:
        return None
    c = program["counters"]
    if not c.get("mega.lanes"):
        return None
    return 100.0 * c.get("mega.live", 0) / c["mega.lanes"]
