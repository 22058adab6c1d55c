"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free [arXiv:2410.05355].

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, d_inner=8192
(expand 2), dt_rank=256, conv k=4.  Runs the long_500k cell: decode state is
O(1) in context length.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    head_dim=64,
    ssm_state=16,
    mamba_version=1,
    expand=2,
    d_conv=4,
    dt_rank=256,
)

SMOKE = smoke_variant(CONFIG, n_heads=1, n_kv_heads=1, d_ff=0)
