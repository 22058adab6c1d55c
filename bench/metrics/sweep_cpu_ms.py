"""The host thread's CPU time in a sweep: the ``sweep`` span's thread CPU
clock from its start to its end.  Unlike a wall, it leaves out the time
the thread waited, so it tells the host's work from its waits."""

from bench.harness import spans

UNIT = "ms"
WRAPS = ()
REDUCTION = "thread CPU time of the sweep spans summed over the window, over its sweeps"


def read(w):
    return spans.cpu_ms(w, "sweep")
