"""Scoring a sweep: every shard's stream matrix built on the host, copied
to the card, scored by the ``stream_rf`` kernel in one launch and read
back (``_score_all``)."""

UNIT = "ms"
WRAPS = ("repro_torch.core.fleet:_score_all",)
REDUCTION = "span time summed over the window, over its sweeps"


def read(w):
    return w.per_sweep_ms(w.total_s(*WRAPS))
