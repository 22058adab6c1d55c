"""The fleet layer's end of a sweep, timed inside the program: the
``readback`` span (each replay output brought to the host, a ``wait``
each) and the ``results`` span (every lane's result assembled)."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "wall of the readback and results spans summed over the window, over its sweeps"


def read(w):
    return spans.wall_ms(w, "readback", "results")
