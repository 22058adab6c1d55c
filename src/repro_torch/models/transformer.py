"""Decoder-only LM trunk of the dense family (GQA, optional qk-norm, RoPE,
SwiGLU), trained and served on one card.

The layer loop is a Python loop over ``params.layers``; with
``cfg.remat == "block"`` each block is recomputed in the backward pass.
Caches keep the reference's stacked layout at the public functions:
``{"k": (L,B,S,KV,hd), "v": ...}``.

* ``loss_fn(cfg, params, batch)``                  — mean next-token NLL
* ``prefill(cfg, params, batch)``                  — last logits + KV cache
* ``decode_step(cfg, params, cache, tokens, pos)`` — one serve step; writes
  the new k/v into ``cache`` in place
"""

from __future__ import annotations

import functools
import math

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .params import ModelParams, leaf_name


def _layer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    D, F = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    nl = cfg.n_layers
    s = {
        "attn_norm": (nl, D),
        "mlp_norm": (nl, D),
        "wq": (nl, D, H, hd),
        "wk": (nl, D, KV, hd),
        "wv": (nl, D, KV, hd),
        "wo": (nl, H, hd, D),
    }
    if cfg.qk_norm:
        s["q_norm"] = (nl, hd)
        s["k_norm"] = (nl, hd)
    s["w1"] = (nl, D, F)
    s["w2"] = (nl, F, D)
    if cfg.swiglu:
        s["w3"] = (nl, D, F)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """Leaf -> shape, as the reference's ``param_specs`` without the
    sharding axes."""

    V, D = cfg.padded_vocab, cfg.d_model
    top = {"tok_emb": (V, D), "final_norm": (D,), "layers": _layer_shapes(cfg)}
    if not cfg.tie_embeddings:
        top["lm_head"] = (D, V)
    return top


def empty_params(cfg: ModelConfig, device, dtype_of_leaf=None) -> ModelParams:
    dt = L.dtype_of(cfg)
    return ModelParams(param_specs(cfg), dtype_of_leaf or (lambda name: dt),
                       torch.device(device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> ModelParams:
    """The reference's init scales (norms 1, embeddings 0.02, the rest
    0.02/sqrt(2L)), drawn in f32 from ``generator`` on its device."""

    params = empty_params(cfg, generator.device)
    for name, t in params.named_parameters():
        leaf = leaf_name(name)
        if "norm" in leaf:
            t.fill_(1)
            continue
        scale = 0.02 if "emb" in leaf else 0.02 / math.sqrt(2 * cfg.n_layers)
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * scale)
    return params


def _block(cfg: ModelConfig, w, x, positions, kv_cache=None, cache_position=None):
    h, new_cache = L.attention(cfg, w, L.rms_norm(x, w.attn_norm, cfg.norm_eps),
                               positions=positions, kv_cache=kv_cache,
                               cache_position=cache_position)
    x = x + h
    x = x + L.mlp(cfg, w, L.rms_norm(x, w.mlp_norm, cfg.norm_eps))
    return x, new_cache


def forward(cfg: ModelConfig, params: ModelParams, tokens: torch.Tensor,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden, (k, v) stacked on L or None)."""

    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ks, vs = [], []
    block = functools.partial(L.checkpointed, _block) if cfg.remat == "block" else _block
    for w in params.layers:
        x, (k, v) = block(cfg, w, x, positions)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_cache else None)


def loss_fn(cfg: ModelConfig, params: ModelParams, batch: dict) -> torch.Tensor:
    hidden, _ = forward(cfg, params, batch["tokens"])
    logits = L.lm_logits(cfg, params, hidden)
    return L.cross_entropy(cfg, logits, batch["labels"])


def prefill(cfg: ModelConfig, params: ModelParams, batch: dict):
    """Run the full prompt; returns last-position logits (B,1,V) and the
    stacked KV cache {"k": (L,B,S,KV,hd), "v": ...}."""

    hidden, (k, v) = forward(cfg, params, batch["tokens"], collect_cache=True)
    return L.lm_logits(cfg, params, hidden[:, -1:, :]), {"k": k, "v": v}


def decode_step(cfg: ModelConfig, params: ModelParams, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step: ``tokens`` is (B, 1); ``pos`` the write index into the
    (B, S_ctx) cache.  Returns (logits, cache), the cache updated in place."""

    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    positions = torch.full((tokens.shape[0], 1), int(pos), device=tokens.device)
    for i, w in enumerate(params.layers):
        x, _ = _block(cfg, w, x, positions, kv_cache=(cache["k"][i], cache["v"][i]),
                      cache_position=pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.lm_logits(cfg, params, x), cache


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The cache's shapes and dtypes, as tensors on the meta device."""

    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim_)
    return {key: torch.empty(shape, dtype=L.dtype_of(cfg), device="meta")
            for key in ("k", "v")}
