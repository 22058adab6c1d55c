"""internvl2-26b [vlm] — InternViT + InternLM2-20B backbone [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded to 92672 for
TP divisibility).  The ViT frontend is a stub: ``input_specs()`` provides
256 precomputed patch embeddings (InternVL's 1024 patches after 0.25x pixel
shuffle) occupying the first positions of the sequence.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,
    head_dim=128,
    swiglu=True,
    rope_theta=1e6,
    n_patches=256,
)

SMOKE = smoke_variant(CONFIG)
