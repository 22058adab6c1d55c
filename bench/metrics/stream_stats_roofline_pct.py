"""The ``stream_stats`` kernel's share of its roofline: the least time of
the window's scoring (bytes, counted from the traces) over the kernel's
time by CUDA events around each launch."""

UNIT = "%"
WRAPS = ("repro_torch.kernels.stream_rf.kernel:load().stream_stats_launch",)
REDUCTION = "bound summed over the window's sweeps / kernel time summed over them"


def read(w):
    if w.counts is None:
        return None
    return w.roofline_pct(w.stream_stats_bound_s(w.counts), WRAPS[0])
