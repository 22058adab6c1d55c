"""Stacking and packing a sweep's lanes, timed inside the program: the
``stack`` span (the lane-major tape, the lane constants and initial
states) and the ``pack`` span (packing into one buffer and its one copy to
the card)."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the stack and pack spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "stack", "pack")
