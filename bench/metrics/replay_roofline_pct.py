"""The ``replay`` kernel's share of its roofline: the least time of the
window's replays (the larger of the byte and the float64 operation bound,
counted from the traces) over the kernel's time by CUDA events."""

UNIT = "%"
WRAPS = ("repro_torch.kernels.replay.kernel:load().replay_launch",)
REDUCTION = "bound summed over the window's sweeps / kernel time summed over them"


def read(w):
    if w.counts is None:
        return None
    return w.roofline_pct(w.replay_bound_s(w.counts)[0], WRAPS[0])
