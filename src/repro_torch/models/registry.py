"""Uniform model API over the ported families (``--arch`` dispatch)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers, mamba, transformer

_FAMILY_MODULES = {"dense": transformer, "ssm": mamba}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    param_specs: Callable  # () -> leaf shapes
    init_params: Callable  # (seed or torch.Generator) -> ModelParams on device
    forward: Callable  # (params, tokens) -> (hidden, None)
    prefill: Callable  # (params, batch) -> (logits, cache)
    decode_step: Callable  # (params, cache, tokens, pos) -> (logits, cache)
    abstract_cache: Callable  # (batch, seq) -> cache of meta tensors


def get_model(cfg: ModelConfig, device: "torch.device | str | None" = None) -> ModelApi:
    """The model API of ``cfg`` on ``device`` (``None``: the CUDA card,
    raising without one).  Raises ``NotImplementedError`` for a family or
    perf lever this slice of the port does not serve."""

    dev = resolve_device(device)
    layers.check_ported(cfg)
    mod = _FAMILY_MODULES[cfg.family]

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
        forward=lambda params, tokens: mod.forward(cfg, params, tokens),
        prefill=lambda params, batch: mod.prefill(cfg, params, batch),
        decode_step=lambda params, cache, tokens, pos: mod.decode_step(
            cfg, params, cache, tokens, pos),
        abstract_cache=lambda batch, seq: mod.abstract_cache(cfg, batch, seq),
    )
