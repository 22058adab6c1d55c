"""FlashAttention-2 forward: the CUDA kernel, its loader, its wrappers
(:mod:`.ops`) and its plain torch version (:mod:`.ref`)."""
