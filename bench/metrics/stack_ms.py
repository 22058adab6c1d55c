"""Stacking and packing a sweep's lanes on the host: the lane-major tape,
the lane constants and initial states (``FleetProgram._lane_inputs``, less
the shard, score and tape spans inside it) and the packing into one
buffer with its one copy to the card (``replay_inputs``)."""

UNIT = "ms"
WRAPS = ("repro_torch.core.fleet:FleetProgram._lane_inputs",
         "repro_torch.core.engine_device:replay_inputs")
EXCLUDES = ("repro_torch.core.fleet:assign_nodes",
            "repro_torch.core.trace:TraceBatch.shard",
            "repro_torch.core.fleet:_score_all",
            "repro_torch.core.engine_device:build_events",
            "repro_torch.core.engine_device:per_app_bytes")
REDUCTION = "self time summed over the window, over its sweeps"


def read(w):
    stack, pack = w.self_s(WRAPS[0], EXCLUDES), w.total_s(WRAPS[1])
    if stack is None or pack is None:
        return None
    return w.per_sweep_ms(stack + pack)
