"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    swiglu=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = smoke_variant(CONFIG)
