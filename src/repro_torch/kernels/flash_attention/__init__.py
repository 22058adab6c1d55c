"""FlashAttention forward: the CUDA kernel (tensor cores in bf16, CUDA
cores in f32), its loader, its wrappers (:mod:`.ops`) and its plain torch
version (:mod:`.ref`)."""
