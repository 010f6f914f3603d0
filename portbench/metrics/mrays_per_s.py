"""Rays of every launch completed in the window, over the window's wall,
in millions per second (host clock; rays from the launches' alive counts,
``raycount.py``)."""


def read(rec):
    rays = rec.values.get("rays")
    if rays is None or rec.window_s <= 0:
        return None
    return rays / rec.window_s / 1e6
