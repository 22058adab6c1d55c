"""Step functions (train / prefill / serve) over a ModelApi."""

from __future__ import annotations

import torch

from ..models.registry import ModelApi
from ..optim import AdamWConfig, CompressionConfig, apply_updates, compress_tree


def make_train_step(model: ModelApi, opt_cfg: AdamWConfig | None = None,
                    comp_cfg: CompressionConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (accumulated over microbatches
    of ``cfg.microbatch`` sequences when set), gradient compression
    (identity when disabled) and one AdamW step, which updates ``params``
    and ``opt_state`` in place.  ``opt_state`` is
    ``init_state(dict(params.named_parameters()))``; ``batch`` holds
    ``tokens`` and ``labels`` tensors on the model's device; ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr``.

    Raises ``ValueError`` for ``attention_impl`` or ``ssm_impl`` ``"kernel"``:
    the kernels have no backward pass (nor have the reference's).  Raises
    ``NotImplementedError`` for compression of the hybrid family, whose
    reference rows are groups of layers (not ported)."""

    opt_cfg = opt_cfg or AdamWConfig()
    comp_cfg = comp_cfg or CompressionConfig()
    cfg = model.cfg
    if comp_cfg.enabled and cfg.family == "hybrid":
        raise NotImplementedError("gradient compression of the hybrid family is not ported")
    for field in ("attention_impl", "ssm_impl"):
        if getattr(cfg, field) == "kernel":
            raise ValueError(f"{field}='kernel' has no backward pass; train with "
                             f"{field}='torch'")
    mb = cfg.microbatch

    def grads_of(params, batch: dict):
        leaves = list(params.parameters())
        if not mb:
            loss = model.loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        # gradient accumulation over microbatches: the loss averaged, the
        # grads summed in f32 and scaled by 1/a
        b = batch["tokens"].shape[0]
        if b % mb != 0:
            raise ValueError(f"batch {b} not divisible by microbatch {mb}")
        a = b // mb
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(a):
            loss = model.loss_fn(params, {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()})
            for s, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                s.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / a
        return loss_sum * inv, [g * inv for g in gsum]

    def train_step(params, opt_state: dict, batch: dict):
        params.requires_grad_()
        loss, grads = grads_of(params, batch)
        tree = dict(params.named_parameters())
        grads = _compress_as_reference(dict(zip(tree, grads)), comp_cfg)
        _, opt_state, metrics = apply_updates(opt_cfg, tree, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def _compress_as_reference(grads: dict, cfg: CompressionConfig) -> dict:
    """Cross-pod gradient compression (identity when disabled), with the
    error dropped each step as the reference's step drops it.  Compression
    scales each row (first axis) of a leaf, and the reference stacks a
    per-layer leaf on L, so there a layer's whole leaf is one row: each
    per-layer leaf (``layers.<i>.<name>``) goes in with a leading axis of 1."""

    def per_layer(k: str) -> bool:
        return k.startswith("layers.")

    out, _ = compress_tree({k: g[None] if per_layer(k) else g for k, g in grads.items()},
                           None, cfg)
    return {k: out[k][0] if per_layer(k) else out[k] for k in grads}


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
