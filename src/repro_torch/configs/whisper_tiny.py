"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

4L d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865 (padded 51968).
Encoder: 4 layers over 1500 stubbed frame embeddings.  Sinusoidal positions
(rope_theta=0), GELU MLP.  Decode shapes lower the decoder serve step.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    head_dim=64,
    swiglu=False,
    rope_theta=0.0,  # sinusoidal absolute positions
    encoder_layers=4,
    n_frames=1500,
    tie_embeddings=True,
)

SMOKE = smoke_variant(CONFIG)
