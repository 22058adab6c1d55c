"""The fleet layer's own time a sweep: ``FleetProgram.run`` less the
layers it calls (the inputs of every lane, their packing and copy, and
the replay's launch): the read-back of the replay's outputs and the
assembly of every lane's result are most of it."""

UNIT = "ms"
WRAPS = ("repro_torch.core.fleet:FleetProgram.run",)
EXCLUDES = ("repro_torch.core.fleet:FleetProgram._lane_inputs",
            "repro_torch.core.engine_device:replay_inputs",
            "repro_torch.kernels.replay.ops:replay_op")
REDUCTION = "self time summed over the window, over its sweeps"


def read(w):
    return w.per_sweep_ms(w.self_s(WRAPS[0], EXCLUDES))
