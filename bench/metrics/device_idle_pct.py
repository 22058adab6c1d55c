"""The share of the window's sweep time in which nothing ran on the card:
100 less the busy share, busy being the profiler's device time (kernels,
the two kernels launched through ctypes among them, and copies)."""

UNIT = "%"
WRAPS = ()
REDUCTION = "100 * (1 - busy seconds / summed sweep seconds)"


def read(w):
    busy = w.busy_s()
    if busy is None or not w.window_s:
        return None
    return 100.0 * (1.0 - busy / w.window_s)
