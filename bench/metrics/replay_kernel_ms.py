"""The ``replay`` kernel's device time a sweep, by CUDA events around its
launch.  The host span of ``replay_op`` is recorded too, so that the fleet
layer's self time leaves the replay layer out."""

UNIT = "ms"
WRAPS = ("repro_torch.kernels.replay.ops:replay_op",
         "repro_torch.kernels.replay.kernel:load().replay_launch")
REDUCTION = "kernel time summed over the window, over its sweeps"


def read(w):
    return w.per_sweep_ms(w.launch_s(WRAPS[1]))
