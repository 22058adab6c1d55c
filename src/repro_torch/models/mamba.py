"""Attention-free SSM LM (falcon-mamba-7b family, Mamba-1 blocks), trained
and served on one card or, with DTensor parameters and inputs, on a mesh
(each rank runs the conv and the scan on its channels: ``layers.mamba1_block``).
With ``cfg.remat == "block"`` each block is recomputed in the backward pass.

Decode state is O(1) in context length: the conv window (K-1 inputs) and
the SSM hidden state (d_inner x state) per layer, kept in the reference's
stacked layout ``{"conv": (L,B,K-1,DI), "h": (L,B,DI,N) f32}``; under a mesh
both come out laid out as ``cache_axes`` gives them.
"""

from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .layers import SSMState
from .params import ModelParams, leaf_name, map_specs


def _specs(cfg: ModelConfig) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    di, n, dr, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.d_conv
    nl = cfg.n_layers
    layers = {
        "norm": ((nl, D), ("layers", None)),
        "in_proj": ((nl, D, 2 * di), ("layers", "embed", "inner")),
        "conv_w": ((nl, K, di), ("layers", None, "inner")),
        "conv_b": ((nl, di), ("layers", "inner")),
        "x_proj": ((nl, di, dr + 2 * n), ("layers", "inner", None)),
        "dt_proj": ((nl, dr, di), ("layers", None, "inner")),
        "dt_bias": ((nl, di), ("layers", "inner")),
        "A_log": ((nl, di, n), ("layers", "inner", None)),
        "D": ((nl, di), ("layers", "inner")),
        "out_proj": ((nl, di, D), ("layers", "inner", "embed")),
    }
    return {"tok_emb": ((V, D), ("vocab", "embed")), "final_norm": ((D,), (None,)),
            "lm_head": ((D, V), ("embed", "vocab")), "layers": layers}


def param_specs(cfg: ModelConfig) -> dict:
    """Leaf -> shape, as the reference's ``param_specs`` without the
    sharding axes."""

    return map_specs(_specs(cfg), lambda shape, axes: shape)


def param_axes(cfg: ModelConfig) -> dict:
    """Leaf -> logical axes, nested as :func:`param_specs`; a per-layer
    leaf's are the reference's without the leading ``"layers"``."""

    return map_specs(_specs(cfg), lambda shape, axes: axes, {"layers": 1})


def abstract_params(cfg: ModelConfig) -> ModelParams:
    """The parameters as meta tensors, in their storage dtypes."""

    return empty_params(cfg, "meta")


def empty_params(cfg: ModelConfig, device, dtype_of_leaf=None) -> ModelParams:
    dt = L.dtype_of(cfg)

    def default(name: str) -> torch.dtype:
        return torch.float32 if name == "A_log" else dt  # scan dynamics stay f32

    return ModelParams(param_specs(cfg), dtype_of_leaf or default, torch.device(device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> ModelParams:
    """The reference's init: norms and D at 1, A = -(1..N) per channel
    (S4D-real), dt_bias = softplus^-1(0.01), conv bias 0, the rest
    N(0, 0.02) drawn in f32 from ``generator`` on its device."""

    params = empty_params(cfg, generator.device)
    for name, t in params.named_parameters():
        leaf = leaf_name(name)
        if "norm" in leaf or leaf == "D":
            t.fill_(1)
        elif leaf == "A_log":
            t.copy_(torch.log(torch.arange(1, t.shape[-1] + 1, dtype=torch.float32,
                                           device=t.device)).expand(t.shape))
        elif leaf == "dt_bias":
            t.fill_(-4.6)
        elif leaf.endswith("_b"):
            t.zero_()
        else:
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.02)
    return params


def _layer(cfg: ModelConfig, w, x: torch.Tensor, st: SSMState | None):
    y, new = L.mamba1_block(cfg, w, L.rms_norm(x, w.norm, cfg.norm_eps), st)
    return x + y, new


def forward(cfg: ModelConfig, params: ModelParams, tokens: torch.Tensor,
            states: dict | None = None, collect_state: bool = False):
    """states: stacked decode state {"conv": (L,B,K-1,DI), "h": (L,B,DI,N)}.
    Returns (hidden, new stacked state or None)."""

    x = L.embed_tokens(cfg, params.tok_emb, tokens)
    layer = functools.partial(L.checkpointed, _layer) if cfg.remat == "block" else _layer
    convs, hs = [], []
    for i, w in enumerate(params.layers):
        st = None if states is None else SSMState(conv=states["conv"][i], h=states["h"][i])
        x, new = layer(cfg, w, x, st)
        convs.append(new.conv)
        hs.append(new.h)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if collect_state or states is not None:
        return x, {"conv": torch.stack(convs), "h": torch.stack(hs)}
    return x, None


def loss_fn(cfg: ModelConfig, params: ModelParams, batch: dict) -> torch.Tensor:
    hidden, _ = forward(cfg, params, batch["tokens"])
    logits = L.lm_logits(cfg, params, hidden)
    return L.cross_entropy(cfg, logits, batch["labels"])


def prefill(cfg: ModelConfig, params: ModelParams, batch: dict):
    hidden, state = forward(cfg, params, batch["tokens"], collect_state=True)
    return L.lm_logits(cfg, params, hidden[:, -1:, :]), state


def decode_step(cfg: ModelConfig, params: ModelParams, state: dict,
                tokens: torch.Tensor, pos: int):
    """SSM serve step; ``pos`` is unused (the state is position-free)."""

    del pos
    hidden, new_state = forward(cfg, params, tokens, states=state)
    return L.lm_logits(cfg, params, hidden), new_state


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode state's shapes and dtypes, as tensors on the meta device;
    ``seq`` is irrelevant (O(1) state) but kept for the API."""

    del seq
    nl, di, n, K = cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    return {
        "conv": torch.empty((nl, batch, K - 1, di), dtype=L.dtype_of(cfg), device="meta"),
        "h": torch.empty((nl, batch, di, n), dtype=torch.float32, device="meta"),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    return {"conv": ("layers", "cache_batch", None, "inner"),
            "h": ("layers", "cache_batch", "inner", None)}
