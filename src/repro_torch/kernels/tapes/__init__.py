"""The event tape's per-stream anchors: the CUDA kernel, its loader, its
wrapper (:mod:`.ops`) and its plain NumPy version (:mod:`.ref`)."""
