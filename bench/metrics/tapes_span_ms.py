"""Building a sweep's event tapes on the host, timed inside the program:
the ``tapes`` span around ``build_events`` and ``per_app_bytes`` of every
shard."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the tapes spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "tapes")
