"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
8 experts do not divide the 16-way model axis -> experts replicate and each
expert's d_ff (32768/16) carries TP (automatic fallback; DESIGN.md §5).
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131_072,
    head_dim=128,
    swiglu=True,
    rope_theta=10_000.0,
    n_experts=8,
    experts_per_token=2,
)

SMOKE = smoke_variant(CONFIG)
