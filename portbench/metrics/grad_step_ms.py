"""The window's wall over the inverse-rendering steps it completed, in ms
(host clock; each step closed by its loss's value on the host)."""


def read(rec):
    steps = rec.values.get("steps")
    if not steps:
        return None
    return rec.window_s / steps * 1e3
