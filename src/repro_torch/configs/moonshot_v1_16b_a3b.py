"""moonshot-v1-16b-a3b [moe] — 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (MHA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64e top-6.  Experts shard 64/16 over the model axis — true expert
parallelism (the shared-expert and MLA pieces of Moonlight are omitted;
DESIGN.md §8).
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    head_dim=128,
    swiglu=True,
    rope_theta=50_000.0,
    n_experts=64,
    experts_per_token=6,
)

SMOKE = smoke_variant(CONFIG)
