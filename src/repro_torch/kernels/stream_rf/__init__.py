"""Per-stream Eq. 1 / Eq. 6 scoring: the CUDA kernel, its loader, its
wrappers (:mod:`.ops`) and its plain torch version (:mod:`.ref`)."""
