"""Encoder-decoder trunk (the whisper-tiny family), trained and served on one
card or, with DTensor parameters and inputs, on a mesh: the reference's
sharding points (the frames on ``("batch", "frames", None)``, the logits on
``("batch", None, "vocab")``, the self-attention caches on ``cache_seq``),
the sinusoid tables replicated, cross attention on each rank's rows and
heads through ``local_map`` as self attention, and the tied head as the
explicit product over a split vocab.

The audio conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, n_frames, D), the output of
Whisper's two conv layers.  Sinusoidal positions on both stacks, LayerNorm,
GELU MLP, MHA (kv == heads), no RoPE, no biases on the projections.  The
encoder's self attention (non-causal) and the decoder's (causal) run
through the ``flash_attention`` kernel under ``attention_impl="kernel"``;
cross attention runs the layer's direct path under either impl, as the
reference's never reaches its kernel.  The head is tied to ``tok_emb``.

Caches keep the reference's stacked layout: ``{"k", "v": (L,B,S,KV,hd),
"cross_k", "cross_v": (L,B,n_frames,KV,hd)}``; a decode step writes the
new self-attention k/v into ``k``/``v`` in place and reads the cross cache.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from . import layers as L
from .params import EncDecParams, leaf_name, map_specs


def _sinusoid(length: int, dim: int) -> np.ndarray:
    """The prefill table: in f64 with NumPy, cast to f32."""

    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * i / dim)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(np.float32)


def _sinusoid_like(x: torch.Tensor, length: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """The prefill table in ``dtype`` on ``x``'s device, a replicated
    DTensor when ``x`` is one.  Made at each call on the CPU: a cached table
    would be a real tensor that a CPU dry run's FakeTensorMode refuses, or
    a fake one cached under it."""

    if x.device.type == "cpu":
        table = torch.as_tensor(_sinusoid(length, dim)).to(dtype)
    else:
        table = _sinusoid_on(length, dim, dtype, x.device)
    return L.replicated_like(x, table)


@functools.lru_cache(maxsize=None)
def _sinusoid_on(length: int, dim: int, dtype: torch.dtype, device: torch.device):
    # copied to the device once: a copy from pageable host memory would
    # synchronise the stream at every call
    return torch.from_numpy(_sinusoid(length, dim)).to(device=device, dtype=dtype)


def _sinusoid_at(pos: int, dim: int, device: torch.device) -> torch.Tensor:
    """The decode row for one position, computed in f32."""

    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    angle = torch.tensor(float(pos), device=device) / torch.pow(
        torch.tensor(10_000.0, device=device), 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _attn_specs(nl: int, cfg: ModelConfig, prefix: str) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        f"{prefix}wq": ((nl, D, H, hd), ("layers", "embed", "heads", None)),
        f"{prefix}wk": ((nl, D, KV, hd), ("layers", "embed", "kv_heads", None)),
        f"{prefix}wv": ((nl, D, KV, hd), ("layers", "embed", "kv_heads", None)),
        f"{prefix}wo": ((nl, H, hd, D), ("layers", "heads", None, "embed")),
    }


def _specs(cfg: ModelConfig) -> dict:
    V, D, F = cfg.padded_vocab, cfg.d_model, cfg.d_ff
    ne, nd = cfg.encoder_layers, cfg.n_layers

    def norms(nl, *names):
        return {k: ((nl, D), ("layers", None)) for k in names}

    enc = {
        **norms(ne, "attn_norm", "attn_norm_b", "mlp_norm", "mlp_norm_b"),
        "w1": ((ne, D, F), ("layers", "embed", "mlp")),
        "w2": ((ne, F, D), ("layers", "mlp", "embed")),
        **_attn_specs(ne, cfg, ""),
    }
    dec = {
        **norms(nd, "self_norm", "self_norm_b", "cross_norm", "cross_norm_b", "mlp_norm",
                "mlp_norm_b"),
        "w1": ((nd, D, F), ("layers", "embed", "mlp")),
        "w2": ((nd, F, D), ("layers", "mlp", "embed")),
        **_attn_specs(nd, cfg, "self_"),
        **_attn_specs(nd, cfg, "cross_"),
    }
    top = {k: ((D,), (None,)) for k in ("enc_final_norm", "enc_final_norm_b",
                                         "dec_final_norm", "dec_final_norm_b")}
    return {"tok_emb": ((V, D), ("vocab", "embed")), **top, "encoder": enc, "decoder": dec}


def param_specs(cfg: ModelConfig) -> dict:
    """Leaf -> shape, as the reference's ``param_specs`` without the
    sharding axes."""

    return map_specs(_specs(cfg), lambda shape, axes: shape)


def param_axes(cfg: ModelConfig) -> dict:
    """Leaf -> logical axes, nested as :func:`param_specs`; a per-layer
    leaf's are the reference's without the leading ``"layers"``."""

    return map_specs(_specs(cfg), lambda shape, axes: axes, {"encoder": 1, "decoder": 1})


def abstract_params(cfg: ModelConfig) -> EncDecParams:
    """The parameters as meta tensors, in their storage dtypes."""

    return empty_params(cfg, "meta")


def empty_params(cfg: ModelConfig, device, dtype_of_leaf=None) -> EncDecParams:
    dt = L.dtype_of(cfg)
    return EncDecParams(param_specs(cfg), dtype_of_leaf or (lambda name: dt),
                        torch.device(device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> EncDecParams:
    """The reference's init scales (norm scales 1, norm biases 0, the rest
    0.02 with no depth scaling), drawn in f32 from ``generator`` on its
    device."""

    params = empty_params(cfg, generator.device)
    for name, t in params.named_parameters():
        leaf = leaf_name(name)
        if leaf.endswith("_b"):
            t.zero_()
        elif "norm" in leaf:
            t.fill_(1)
        else:
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.02)
    return params


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _sub(w, prefix: str):
    """The attention leaves of ``w`` named ``<prefix>wq`` ... as ``wq`` ..."""

    return types.SimpleNamespace(**{k: getattr(w, prefix + k) for k in ("wq", "wk", "wv", "wo")})


def _encoder_block(cfg: ModelConfig, w, x, positions):
    h = L.layer_norm(x, w.attn_norm, w.attn_norm_b, cfg.norm_eps)
    o, _ = L.attention(cfg, w, h, positions=positions, causal=False)
    x = x + o
    h = L.layer_norm(x, w.mlp_norm, w.mlp_norm_b, cfg.norm_eps)
    return x + L.mlp(cfg, w, h)


def encode(cfg: ModelConfig, params: EncDecParams, frames: torch.Tensor) -> torch.Tensor:
    dt = L.dtype_of(cfg)
    t = frames.shape[1]
    x = frames.to(dt) + _sinusoid_like(frames, t, cfg.d_model, dt)[None]
    x = L.constrain(x, "batch", "frames", None)
    positions = torch.arange(t, device=frames.device)
    block = (functools.partial(L.checkpointed, _encoder_block) if cfg.remat == "block"
             else _encoder_block)
    for w in params.encoder:
        x = block(cfg, w, x, positions)
    return L.layer_norm(x, params.enc_final_norm, params.enc_final_norm_b, cfg.norm_eps)


def _decoder_block(cfg: ModelConfig, w, x, positions, enc_out):
    h = L.layer_norm(x, w.self_norm, w.self_norm_b, cfg.norm_eps)
    o, (k, v) = L.attention(cfg, _sub(w, "self_"), h, positions=positions, causal=True)
    x = x + o
    # cross attention: the encoder's K/V projected with this layer's weights
    ck, cv = L._matmul(enc_out, w.cross_wk), L._matmul(enc_out, w.cross_wv)
    h = L.layer_norm(x, w.cross_norm, w.cross_norm_b, cfg.norm_eps)
    o, _ = L.attention(cfg, _sub(w, "cross_"), h, positions=positions, cross_kv=(ck, cv))
    x = x + o
    h = L.layer_norm(x, w.mlp_norm, w.mlp_norm_b, cfg.norm_eps)
    return x + L.mlp(cfg, w, h), (k, v, ck, cv)


def forward(cfg: ModelConfig, params: EncDecParams, tokens: torch.Tensor,
            frames: torch.Tensor, collect_cache: bool = False):
    """Encode ``frames``, then the decoder over ``tokens``.  Returns (hidden,
    cache dict or None)."""

    enc_out = encode(cfg, params, frames)
    dt = L.dtype_of(cfg)
    s = tokens.shape[1]
    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    x = x + _sinusoid_like(x, s, cfg.d_model, dt)[None]
    positions = torch.arange(s, device=tokens.device)
    block = (functools.partial(L.checkpointed, _decoder_block) if cfg.remat == "block"
             else _decoder_block)
    caches = []
    for w in params.decoder:
        x, cache = block(cfg, w, x, positions, enc_out)
        if collect_cache:
            caches.append(cache)
    x = L.layer_norm(x, params.dec_final_norm, params.dec_final_norm_b, cfg.norm_eps)
    if not collect_cache:
        return x, None
    cache = {key: torch.stack(ts) for key, ts in zip(("k", "v", "cross_k", "cross_v"),
                                                     zip(*caches))}
    return x, _constrain_self_caches(cache)


def _constrain_self_caches(cache: dict) -> dict:
    return {k: L.constrain(v, None, "batch", "cache_seq", None, None) if k in ("k", "v") else v
            for k, v in cache.items()}


def _logits(params: EncDecParams, x: torch.Tensor) -> torch.Tensor:
    """The tied head (bsd,vd->bsv); on DTensors the explicit FSDP x TP
    product over a split vocab (``layers._matmul``)."""

    head = params.tok_emb.T
    logits = L._matmul(x, head) if isinstance(x, DTensor) else x @ head
    return L.constrain(logits, "batch", None, "vocab")


def loss_fn(cfg: ModelConfig, params: EncDecParams, batch: dict) -> torch.Tensor:
    hidden, _ = forward(cfg, params, batch["tokens"], batch["frames"])
    return L.cross_entropy(cfg, _logits(params, hidden), batch["labels"])


def prefill(cfg: ModelConfig, params: EncDecParams, batch: dict):
    """Encode the frames and run the decoder over the prompt; returns
    last-position logits (B,1,V) and the cache {"k", "v", "cross_k",
    "cross_v"}."""

    hidden, cache = forward(cfg, params, batch["tokens"], batch["frames"],
                            collect_cache=True)
    return _logits(params, hidden[:, -1:, :]), cache


def decode_step(cfg: ModelConfig, params: EncDecParams, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step of the decoder: ``tokens`` is (B, 1); ``pos`` the
    write index into the self-attention cache.  Returns (logits, cache),
    ``k``/``v`` updated in place."""

    dt = L.dtype_of(cfg)
    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    row = _sinusoid_at(pos, cfg.d_model, tokens.device).to(dt)
    x = x + L.replicated_like(x, row)[None, None, :]
    positions = torch.full((tokens.shape[0], 1), int(pos), device=tokens.device)
    for i, w in enumerate(params.decoder):
        h = L.layer_norm(x, w.self_norm, w.self_norm_b, cfg.norm_eps)
        o, _ = L.attention(cfg, _sub(w, "self_"), h, positions=positions,
                           kv_cache=(cache["k"][i], cache["v"][i]), cache_position=pos)
        x = x + o
        h = L.layer_norm(x, w.cross_norm, w.cross_norm_b, cfg.norm_eps)
        o, _ = L.attention(cfg, _sub(w, "cross_"), h, positions=positions,
                           cross_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        x = x + o
        h = L.layer_norm(x, w.mlp_norm, w.mlp_norm_b, cfg.norm_eps)
        x = x + L.mlp(cfg, w, h)
    x = L.layer_norm(x, params.dec_final_norm, params.dec_final_norm_b, cfg.norm_eps)
    return _logits(params, x), _constrain_self_caches(cache)


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The cache's shapes and dtypes, as tensors on the meta device."""

    dt = L.dtype_of(cfg)
    kv = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim_)
    cross = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim_)
    return {key: torch.empty(shape, dtype=dt, device="meta")
            for key, shape in (("k", kv), ("v", kv), ("cross_k", cross), ("cross_v", cross))}


def cache_axes(cfg: ModelConfig) -> dict:
    kv = ("layers", "cache_batch", "cache_seq", "kv_heads", None)
    cross = ("layers", "cache_batch", "frames", "kv_heads", None)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
