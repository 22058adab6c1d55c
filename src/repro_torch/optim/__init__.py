"""Optimizer substrate of the port: AdamW, schedules, gradient
compression, over dicts of tensors."""

from .adamw import (AdamWConfig, apply_updates, clip_by_global_norm, global_norm,
                    init_state)
from .compression import CompressionConfig, compress_tree, decode, encode, init_error
from .schedules import constant, inverse_sqrt, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "init_state",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "CompressionConfig",
    "compress_tree",
    "encode",
    "decode",
    "init_error",
    "constant",
    "inverse_sqrt",
    "linear_warmup_cosine",
]
