"""The 95th percentile of the traced window's sweep walls (host clock,
each sweep ending in a synchronise): the tail of a host-paced sweep."""

import numpy as np

UNIT = "ms"
WRAPS = ()
REDUCTION = "95th percentile (linear) of the window's sweep walls"


def read(w):
    if len(w.walls) < 20:
        return None
    return float(np.percentile(w.walls, 95)) * 1e3
