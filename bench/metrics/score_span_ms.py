"""Scoring a sweep, timed inside the program: the ``score`` span around
every shard's stream matrix, its copy to the card, the ``stream_stats``
launch and the read-back (a ``wait`` inside it)."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the score spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "score")
