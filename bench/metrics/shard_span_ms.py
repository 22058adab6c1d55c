"""Sharding a sweep, timed inside the program: the ``shard`` span around
the node assignment and the split into per-node traces (a tape-cache
miss only)."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the shard spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "shard")
