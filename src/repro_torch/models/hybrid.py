"""Hybrid SSM + shared-attention LM (zamba2-2.7b family), trained and served
on one card or, with DTensor parameters and inputs, on a mesh (each rank
runs its Mamba-2 heads, ``layers.mamba2_block``; the shared attention on its
rows and heads through ``local_map``).

A Mamba-2 backbone with ONE shared attention + MLP block (a single weight
set) applied after every ``cfg.shared_attn_every``-th Mamba layer, as the
reference's ``models/hybrid.py`` (which omits Zamba2's embedding-concat
input to the shared block and its per-application LoRA deltas).  The
layers form ``n_groups = n_layers // every`` groups of ``every`` Mamba
layers, each followed by one shared-attention application; with
``cfg.remat == "block"`` each Mamba layer is recomputed in the backward
pass.

Decode state keeps the reference's stacked layout: ``{"conv":
(G,E,B,K-1,C), "h": (G,E,B,DI,N) f32, "attn_k"/"attn_v": (G,B,S,KV,hd)}``,
one KV cache per shared application, which a prefill lays out on
``cache_seq`` as the reference's does.  A decode step writes the new k/v
into ``attn_k``/``attn_v`` in place.
"""

from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .layers import SSMState
from .params import HybridParams, leaf_name, map_specs


def n_groups(cfg: ModelConfig) -> int:
    if cfg.shared_attn_every <= 0:
        raise ValueError("shared_attn_every must be positive")
    if cfg.n_layers % cfg.shared_attn_every != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"shared_attn_every {cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def _specs(cfg: ModelConfig) -> dict:
    V, D, F = cfg.padded_vocab, cfg.d_model, cfg.d_ff
    di, n, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    nh = cfg.mamba_heads
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g, e = n_groups(cfg), cfg.shared_attn_every
    conv_ch = di + 2 * n  # Mamba-2 convolves x, B and C together
    mamba = {
        "norm": ((g, e, D), ("layers", None, None)),
        "in_proj": ((g, e, D, 2 * di + 2 * n + nh), ("layers", None, "embed", "inner")),
        "conv_w": ((g, e, K, conv_ch), ("layers", None, None, "inner")),
        "conv_b": ((g, e, conv_ch), ("layers", None, "inner")),
        "dt_bias": ((g, e, nh), ("layers", None, None)),
        "A_log": ((g, e, nh), ("layers", None, None)),
        "D": ((g, e, nh), ("layers", None, None)),
        "out_norm": ((g, e, di), ("layers", None, "inner")),
        "out_proj": ((g, e, di, D), ("layers", None, "inner", "embed")),
    }
    shared = {
        "attn_norm": ((D,), (None,)),
        "mlp_norm": ((D,), (None,)),
        "wq": ((D, H, hd), ("embed", "heads", None)),
        "wk": ((D, KV, hd), ("embed", "kv_heads", None)),
        "wv": ((D, KV, hd), ("embed", "kv_heads", None)),
        "wo": ((H, hd, D), ("heads", None, "embed")),
        "w1": ((D, F), ("embed", "mlp")),
        "w3": ((D, F), ("embed", "mlp")),
        "w2": ((F, D), ("mlp", "embed")),
    }
    return {"tok_emb": ((V, D), ("vocab", "embed")), "final_norm": ((D,), (None,)),
            "lm_head": ((D, V), ("embed", "vocab")), "mamba": mamba, "shared": shared}


def param_specs(cfg: ModelConfig) -> dict:
    """Leaf -> shape, as the reference's ``param_specs`` without the
    sharding axes."""

    return map_specs(_specs(cfg), lambda shape, axes: shape)


def param_axes(cfg: ModelConfig) -> dict:
    """Leaf -> logical axes, nested as :func:`param_specs`; a Mamba leaf's
    are the reference's without the leading ``("layers", None)`` of its
    (G, E) stacking (the port keeps one module a layer)."""

    return map_specs(_specs(cfg), lambda shape, axes: axes, {"mamba": 2})


def abstract_params(cfg: ModelConfig) -> HybridParams:
    """The parameters as meta tensors, in their storage dtypes."""

    return empty_params(cfg, "meta")


def empty_params(cfg: ModelConfig, device, dtype_of_leaf=None) -> HybridParams:
    dt = L.dtype_of(cfg)

    def default(name: str) -> torch.dtype:
        return torch.float32 if name in ("A_log", "dt_bias") else dt  # as the reference's init

    return HybridParams(param_specs(cfg), dtype_of_leaf or default, torch.device(device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> HybridParams:
    """The reference's init: norms and D at 1, A_log 0 (A = -1 a head),
    dt_bias -4.6, conv bias 0, the rest N(0, 0.02) drawn in f32 from
    ``generator`` on its device."""

    params = empty_params(cfg, generator.device)
    for name, t in params.named_parameters():
        leaf = leaf_name(name)
        if "norm" in leaf or leaf == "D":
            t.fill_(1)
        elif leaf == "A_log" or leaf.endswith("_b"):
            t.zero_()
        elif leaf == "dt_bias":
            t.fill_(-4.6)
        else:
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.02)
    return params


def _layer(cfg: ModelConfig, w, x: torch.Tensor, st: SSMState | None):
    y, new = L.mamba2_block(cfg, w, L.rms_norm(x, w.norm, cfg.norm_eps), st)
    return x + y, new


def forward(cfg: ModelConfig, params: HybridParams, tokens: torch.Tensor,
            state: dict | None = None, cache_position: int | None = None,
            collect_state: bool = False):
    """Returns (hidden, the new stacked state or None).  With ``state`` the
    tokens are decoded at ``cache_position``; else they run from position
    0."""

    if state is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    else:
        positions = torch.full((tokens.shape[0], 1), int(cache_position), device=tokens.device)
    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    shared = params.shared
    layer = functools.partial(L.checkpointed, _layer) if cfg.remat == "block" else _layer
    g, e = n_groups(cfg), cfg.shared_attn_every
    want_state = collect_state or state is not None
    convs, hs, ks, vs = [], [], [], []
    for gi in range(g):
        for j in range(e):
            st = None if state is None else SSMState(conv=state["conv"][gi, j],
                                                      h=state["h"][gi, j])
            x, new = layer(cfg, params.layers[gi * e + j], x, st)
            if want_state:
                convs.append(new.conv)
                hs.append(new.h)
        # the shared attention + MLP application
        kv = None if state is None else (state["attn_k"][gi], state["attn_v"][gi])
        o, (k, v) = L.attention(cfg, shared, L.rms_norm(x, shared.attn_norm, cfg.norm_eps),
                                positions=positions, kv_cache=kv,
                                cache_position=cache_position)
        x = x + o
        x = x + L.mlp(cfg, shared, L.rms_norm(x, shared.mlp_norm, cfg.norm_eps))
        if want_state:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if not want_state:
        return x, None
    new_state = {"conv": torch.stack(convs).unflatten(0, (g, e)),
                 "h": torch.stack(hs).unflatten(0, (g, e))}
    if state is None:
        new_state.update({name: L.constrain(torch.stack(t), None, "batch", "cache_seq", None, None)
                          for name, t in (("attn_k", ks), ("attn_v", vs))})
    else:  # the caches were written in place
        new_state.update(attn_k=state["attn_k"], attn_v=state["attn_v"])
    return x, new_state


def loss_fn(cfg: ModelConfig, params: HybridParams, batch: dict) -> torch.Tensor:
    hidden, _ = forward(cfg, params, batch["tokens"])
    logits = L.lm_logits(cfg, params, hidden)
    return L.cross_entropy(cfg, logits, batch["labels"])


def prefill(cfg: ModelConfig, params: HybridParams, batch: dict):
    """Last-position logits (B,1,V) and the stacked decode state."""

    hidden, state = forward(cfg, params, batch["tokens"], collect_state=True)
    return L.lm_logits(cfg, params, hidden[:, -1:, :]), state


def decode_step(cfg: ModelConfig, params: HybridParams, state: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step: ``tokens`` is (B, 1); ``pos`` the write index into the
    (G, B, S_ctx) attention caches.  Returns (logits, new state)."""

    hidden, new_state = forward(cfg, params, tokens, state=state, cache_position=pos)
    return L.lm_logits(cfg, params, hidden), new_state


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode state's shapes and dtypes, as tensors on the meta device."""

    dt = L.dtype_of(cfg)
    g, e = n_groups(cfg), cfg.shared_attn_every
    di, n, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    kv = (g, batch, seq, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "conv": torch.empty((g, e, batch, K - 1, di + 2 * n), dtype=dt, device="meta"),
        "h": torch.empty((g, e, batch, di, n), dtype=torch.float32, device="meta"),
        "attn_k": torch.empty(kv, dtype=dt, device="meta"),
        "attn_v": torch.empty(kv, dtype=dt, device="meta"),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    return {"conv": ("layers", None, "cache_batch", None, "inner"),
            "h": ("layers", None, "cache_batch", "inner", None),
            "attn_k": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
            "attn_v": ("layers", "cache_batch", "cache_seq", "kv_heads", None)}
