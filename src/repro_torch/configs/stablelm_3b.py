"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b family; unverified].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.  StableLM-2 style:
GELU MLP (no gating), standard RoPE.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    head_dim=80,
    swiglu=False,
    rope_theta=10_000.0,
)

SMOKE = smoke_variant(CONFIG)
