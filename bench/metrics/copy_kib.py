"""Bytes copied between host and card in a sweep: the tracer's
``h2d_bytes`` (the score matrix, the packed replay inputs) and
``d2h_bytes`` (every read-back) counters, counted inside each ``sweep``
span, in KiB."""

from bench.harness import spans

UNIT = "KiB"
WRAPS = ()
REDUCTION = "h2d_bytes + d2h_bytes increments of the sweep spans, over the window's sweeps, / 1024"


def read(w):
    n = spans.sweep_count(w, "h2d_bytes", "d2h_bytes")
    return None if n is None else n / 1024
