"""95th percentile, over every launch of the window, of one launch's wall
from its dispatch to its synchronised end, in ms (host clock)."""

import numpy as np


def read(rec):
    launch_s = rec.values.get("launch_s")
    if not launch_s:
        return None
    return float(np.percentile(np.asarray(launch_s) * 1e3, 95))
