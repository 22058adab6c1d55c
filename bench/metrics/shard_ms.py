"""Sharding a sweep: the node assignment of every request
(``assign_nodes``, looked up in the fleet module) and the split into
per-node traces (``TraceBatch.shard``)."""

UNIT = "ms"
WRAPS = ("repro_torch.core.fleet:assign_nodes", "repro_torch.core.trace:TraceBatch.shard")
REDUCTION = "span time summed over the window, over its sweeps"


def read(w):
    return w.per_sweep_ms(w.total_s(*WRAPS))
