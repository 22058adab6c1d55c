"""Decoder-only LM trunk of the dense, MoE and VLM families (GQA, optional
qk-norm, RoPE, SwiGLU or GELU; MoE layers route each token to its top-k
experts; the VLM's patch embeddings take the first positions of the
sequence, its ViT frontend a stub as in the reference), trained and served
on one card.

The layer loop is a Python loop over ``params.layers``; with
``cfg.remat == "block"`` each block is recomputed in the backward pass.
Caches keep the reference's stacked layout at the public functions:
``{"k": (L,B,S,KV,hd), "v": ...}``.

* ``loss_fn(cfg, params, batch)``                  — mean next-token NLL
* ``prefill(cfg, params, batch)``                  — last logits + KV cache

``batch`` holds ``tokens`` (and ``labels`` for the loss); the VLM's also
``patch_embeds`` (B, n_patches, D).
* ``decode_step(cfg, params, cache, tokens, pos)`` — one serve step; writes
  the new k/v into ``cache`` in place
"""

from __future__ import annotations

import functools
import math

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .params import ModelParams, leaf_name, map_specs


def _layer_specs(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], tuple]]:
    """Per-layer leaf -> (shape stacked on L, the reference's logical axes)."""

    D, F = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    nl = cfg.n_layers
    s = {
        "attn_norm": ((nl, D), ("layers", None)),
        "mlp_norm": ((nl, D), ("layers", None)),
        "wq": ((nl, D, H, hd), ("layers", "embed", "heads", None)),
        "wk": ((nl, D, KV, hd), ("layers", "embed", "kv_heads", None)),
        "wv": ((nl, D, KV, hd), ("layers", "embed", "kv_heads", None)),
        "wo": ((nl, H, hd, D), ("layers", "heads", None, "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ((nl, hd), ("layers", None))
        s["k_norm"] = ((nl, hd), ("layers", None))
    if cfg.family == "moe":
        E = cfg.n_experts
        s["router"] = ((nl, D, E), ("layers", "embed", None))
        s["w1"] = ((nl, E, D, F), ("layers", "experts", "embed", "mlp"))
        s["w2"] = ((nl, E, F, D), ("layers", "experts", "mlp", "embed"))
        if cfg.swiglu:
            s["w3"] = ((nl, E, D, F), ("layers", "experts", "embed", "mlp"))
    else:
        s["w1"] = ((nl, D, F), ("layers", "embed", "mlp"))
        s["w2"] = ((nl, F, D), ("layers", "mlp", "embed"))
        if cfg.swiglu:
            s["w3"] = ((nl, D, F), ("layers", "embed", "mlp"))
    return s


def _specs(cfg: ModelConfig) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    top = {"tok_emb": ((V, D), ("vocab", "embed")), "final_norm": ((D,), (None,)),
           "layers": _layer_specs(cfg)}
    if not cfg.tie_embeddings:
        top["lm_head"] = ((D, V), ("embed", "vocab"))
    return top


def param_specs(cfg: ModelConfig) -> dict:
    """Leaf -> shape, as the reference's ``param_specs`` without the
    sharding axes."""

    return map_specs(_specs(cfg), lambda shape, axes: shape)


def param_axes(cfg: ModelConfig) -> dict:
    """Leaf -> logical axes, nested as :func:`param_specs`; a per-layer
    leaf's are the reference's without the leading ``"layers"`` (the port
    keeps one module a layer)."""

    return map_specs(_specs(cfg), lambda shape, axes: axes, {"layers": 1})


def abstract_params(cfg: ModelConfig) -> ModelParams:
    """The parameters as meta tensors, in their storage dtypes."""

    return empty_params(cfg, "meta")


def empty_params(cfg: ModelConfig, device, dtype_of_leaf=None) -> ModelParams:
    """Every leaf in ``param_dtype`` (default: the model dtype), as the
    reference's ``init_params`` stores them, norms included."""

    dt = L.param_dtype_of(cfg)
    return ModelParams(param_specs(cfg), dtype_of_leaf or (lambda name: dt),
                       torch.device(device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> ModelParams:
    """The reference's init scales (norms 1, embeddings and the MoE router
    0.02, the rest 0.02/sqrt(2L)), drawn in f32 from ``generator`` on its
    device and rounded to the storage dtype."""

    params = empty_params(cfg, generator.device)
    for name, t in params.named_parameters():
        leaf = leaf_name(name)
        if "norm" in leaf:
            t.fill_(1)
            continue
        scale = (0.02 if "emb" in leaf or "router" in leaf
                 else 0.02 / math.sqrt(2 * cfg.n_layers))
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * scale)
    return params


def _block(cfg: ModelConfig, w, x, positions, kv_cache=None, cache_position=None):
    h, new_cache = L.attention(cfg, w, L.rms_norm(x, w.attn_norm, cfg.norm_eps),
                               positions=positions, kv_cache=kv_cache,
                               cache_position=cache_position)
    x = x + h
    mlp = L.moe_mlp if cfg.family == "moe" else L.mlp
    x = x + mlp(cfg, w, L.rms_norm(x, w.mlp_norm, cfg.norm_eps))
    return x, new_cache


def _embed_inputs(cfg: ModelConfig, params: ModelParams, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor | None) -> torch.Tensor:
    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError("vlm family needs patch_embeds")
        # patches occupy the first P positions (the ViT frontend is a stub)
        x = torch.cat([patch_embeds.to(x.dtype), x[:, patch_embeds.shape[1]:]], dim=1)
        x = L.constrain(x, "batch", None, None)
    return x


def forward(cfg: ModelConfig, params: ModelParams, tokens: torch.Tensor,
            patch_embeds: torch.Tensor | None = None, collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden, (k, v) stacked on L or None)."""

    x = _embed_inputs(cfg, params, tokens, patch_embeds)
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
    hidden, _ = forward(cfg, params, batch["tokens"], batch.get("patch_embeds"))
    logits = L.lm_logits(cfg, params, hidden)
    return L.cross_entropy(cfg, logits, batch["labels"])


def prefill(cfg: ModelConfig, params: ModelParams, batch: dict):
    """Run the full prompt; returns last-position logits (B,1,V) and the
    stacked KV cache {"k": (L,B,S,KV,hd), "v": ...}."""

    hidden, (k, v) = forward(cfg, params, batch["tokens"], batch.get("patch_embeds"),
                             collect_cache=True)
    cache = {name: L.constrain(t, None, "batch", "cache_seq", None, None)
             for name, t in (("k", k), ("v", v))}
    return L.lm_logits(cfg, params, hidden[:, -1:, :]), cache


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


def cache_axes(cfg: ModelConfig) -> dict:
    ax = ("layers", "cache_batch", "cache_seq", "kv_heads", None)
    return {"k": ax, "v": ax}
