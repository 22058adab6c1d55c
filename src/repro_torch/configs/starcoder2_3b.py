"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  GELU MLP.
24 heads do not divide the 16-way model axis -> attention projections stay
head-replicated and the MLP carries TP (DESIGN.md §4).
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    head_dim=128,
    swiglu=False,
    rope_theta=100_000.0,
)

SMOKE = smoke_variant(CONFIG)
