"""Host synchronisations in a sweep: the program's read-backs of device
tensors (the tracer's ``host_syncs`` counter, counted inside each
``sweep`` span).  A count: it does not depend on the host's speed."""

from bench.harness import spans

UNIT = "count"
WRAPS = ()
REDUCTION = "host_syncs increments of the sweep spans summed over the window, over its sweeps"


def read(w):
    return spans.sweep_count(w, "host_syncs")
