"""Uniform model API over the families (``--arch`` dispatch)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import encdec, hybrid, layers, mamba, transformer

FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "encdec": encdec,
    "ssm": mamba,
    "hybrid": hybrid,
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    param_specs: Callable  # () -> leaf shapes
    init_params: Callable  # (seed or torch.Generator) -> ModelParams on device
    abstract_params: Callable  # () -> ModelParams of meta tensors
    param_axes: Callable  # () -> leaf logical axes, nested as param_specs
    forward: Callable  # (params, tokens, **inputs) -> (hidden, None)
    loss_fn: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> (logits, cache)
    decode_step: Callable  # (params, cache, tokens, pos) -> (logits, cache)
    abstract_cache: Callable  # (batch, seq) -> cache of meta tensors
    cache_axes: Callable  # () -> cache logical axes


def get_model(cfg: ModelConfig, device: "torch.device | str | None" = None) -> ModelApi:
    """The model API of ``cfg`` on ``device`` (``None``: the CUDA card,
    raising without one).  Raises ``NotImplementedError`` for a perf lever
    the port does not have yet, ``ValueError`` for an unknown family."""

    dev = resolve_device(device)
    layers.check_ported(cfg)
    mod = FAMILY_MODULES[cfg.family]

    def init_params(seed):
        gen = seed if isinstance(seed, torch.Generator) else (
            torch.Generator(device=dev).manual_seed(int(seed)))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return mod.init_params(cfg, gen)

    return ModelApi(
        cfg=cfg,
        device=dev,
        param_specs=lambda: mod.param_specs(cfg),
        init_params=init_params,
        abstract_params=lambda: mod.abstract_params(cfg),
        param_axes=lambda: mod.param_axes(cfg),
        # inputs: the VLM's patch_embeds, the encoder-decoder's frames
        forward=lambda params, tokens, **inputs: mod.forward(cfg, params, tokens, **inputs),
        loss_fn=lambda params, batch: mod.loss_fn(cfg, params, batch),
        prefill=lambda params, batch: mod.prefill(cfg, params, batch),
        decode_step=lambda params, cache, tokens, pos: mod.decode_step(
            cfg, params, cache, tokens, pos),
        abstract_cache=lambda batch, seq: mod.abstract_cache(cfg, batch, seq),
        cache_axes=lambda: mod.cache_axes(cfg),
    )


def named_param_axes(cfg: ModelConfig, params) -> dict[str, tuple]:
    """``params.named_parameters()`` name -> logical axes, from the family's
    ``param_axes``: a top-level leaf's own, ``layers.3.wq`` its stack's
    ``wq`` (the hybrid's ``layers.<i>`` its ``mamba`` table's,
    ``shared.wq`` its ``shared`` table's)."""

    axes = FAMILY_MODULES[cfg.family].param_axes(cfg)
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if len(parts) == 1:
            out[name] = axes[name]
            continue
        stack = "mamba" if cfg.family == "hybrid" and parts[0] == "layers" else parts[0]
        out[name] = axes[stack][parts[-1]]
    return out


def frontend_inputs(cfg: ModelConfig, batch: int, seed: int,
                    device: "torch.device | str | None" = None) -> dict:
    """The stubbed modality frontends' outputs for a batch of ``batch``: the
    VLM's ``patch_embeds`` (its first ``n_patches`` positions) or the
    encoder-decoder's ``frames``, standard normal from ``seed`` in the model
    dtype on ``device`` (``None``: the CUDA card); nothing for the other
    families."""

    key, n = {"vlm": ("patch_embeds", cfg.n_patches),
              "encdec": ("frames", cfg.n_frames)}.get(cfg.family, (None, 0))
    if key is None:
        return {}
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {key: torch.randn(batch, n, cfg.d_model, generator=g, device=dev).to(
        layers.dtype_of(cfg))}


def input_specs(cfg: ModelConfig, kind: str, batch: int, seq: int) -> dict:
    """Meta tensors standing for every model input of a step kind:
    ``"train"`` (tokens and labels), ``"prefill"`` (tokens) or ``"decode"``
    (the (B, 1) token batch; the cache comes from ``abstract_cache``).  The
    modality frontends are stubs: the VLM's batch adds ``patch_embeds`` (B,
    n_patches, D), the encoder-decoder's ``frames`` (B, n_frames, D), both
    precomputed embeddings in the model dtype."""

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        specs = {"tokens": meta((batch, seq), torch.int64),
                 "labels": meta((batch, seq), torch.int64)}
    elif kind == "prefill":
        specs = {"tokens": meta((batch, seq), torch.int64)}
    elif kind == "decode":
        specs = {"tokens": meta((batch, 1), torch.int64)}
    else:
        raise ValueError(kind)
    if cfg.family == "vlm" and kind != "decode":
        specs["patch_embeds"] = meta((batch, cfg.n_patches, cfg.d_model), layers.dtype_of(cfg))
    if cfg.family == "encdec" and kind != "decode":
        specs["frames"] = meta((batch, cfg.n_frames, cfg.d_model), layers.dtype_of(cfg))
    return specs


_STACKED = {"layers": ("layers",), "encoder": ("layers",), "decoder": ("layers",),
            "mamba": ("layers", None)}


def stacked_param_axes(cfg: ModelConfig) -> dict:
    """The logical axes in the reference's layout (``tree_from_params``):
    each per-layer leaf's with its stacking on depth in front, which are
    the reference's ``param_axes``."""

    return {k: ({kk: _STACKED[k] + ax for kk, ax in v.items()} if k in _STACKED else v)
            for k, v in FAMILY_MODULES[cfg.family].param_axes(cfg).items()}


def input_axes(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of :func:`input_specs`' tensors."""

    axes: dict = {"tokens": ("batch", None)}
    if kind == "train":
        axes["labels"] = ("batch", None)
    if cfg.family == "vlm" and kind != "decode":
        axes["patch_embeds"] = ("batch", None, None)
    if cfg.family == "encdec" and kind != "decode":
        axes["frames"] = ("batch", "frames", None)
    return axes
