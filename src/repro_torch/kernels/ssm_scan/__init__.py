"""Mamba-1 selective scan: the CUDA kernel, its loader, its wrapper
(:mod:`.ops`) and its plain torch version (:mod:`.ref`)."""
