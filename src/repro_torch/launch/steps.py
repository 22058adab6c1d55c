"""Step functions (prefill / serve) over a ModelApi."""

from __future__ import annotations

import torch

from ..models.registry import ModelApi


def make_prefill_step(model: ModelApi):
    def prefill_step(params, batch: dict):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model: ModelApi):
    def serve_step(params, cache, tokens: torch.Tensor, pos: int):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)  # greedy
        return next_tok[:, None], logits, new_cache

    return serve_step
