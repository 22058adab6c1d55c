"""The host's waits on the card in a sweep: every ``wait`` span, the
program's read-backs of device tensors (the scores, the replay's status,
its outputs), each blocking until the card has finished what it was
given."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the wait spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "wait")
