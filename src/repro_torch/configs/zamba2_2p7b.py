"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 (32H GQA kv=32 in the shared block) d_ff=10240 vocab=32000,
ssm_state=64.  One weight-shared attention+MLP block applied after every 6th
Mamba-2 layer (9 applications).  Runs the long_500k cell (hybrid: O(1) SSM
state + 9 shared-attn cache sweeps).
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    head_dim=80,
    swiglu=True,
    rope_theta=10_000.0,
    ssm_state=64,
    mamba_version=2,
    mamba_headdim=64,
    expand=2,
    shared_attn_every=6,
)

SMOKE = smoke_variant(CONFIG, n_layers=4, shared_attn_every=2)
