"""Building a sweep's event tapes on the host: ``build_events`` and
``per_app_bytes`` for every shard."""

UNIT = "ms"
WRAPS = ("repro_torch.core.engine_device:build_events",
         "repro_torch.core.engine_device:per_app_bytes")
REDUCTION = "span time summed over the window, over its sweeps"


def read(w):
    return w.per_sweep_ms(w.total_s(*WRAPS))
