"""Step functions (train / prefill / serve) over a ModelApi."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import constrain
from ..models.layers import on_local_shards
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
    ``tokens`` and ``labels`` tensors on the model's device (and the VLM's
    ``patch_embeds``, the encoder-decoder's ``frames``); ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr``.

    Raises ``ValueError`` for ``attention_impl`` or ``ssm_impl`` ``"kernel"``:
    the kernels have no backward pass (nor have the reference's)."""

    opt_cfg = opt_cfg or AdamWConfig()
    comp_cfg = comp_cfg or CompressionConfig()
    cfg = model.cfg
    # the hybrid's reference leaves are stacked on (G, E), so a compression
    # row there is a group of E layers; elsewhere (stacked on L) one layer
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 1
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
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i in range(a):
            loss = model.loss_fn(params, {k: _microbatch(v, i, a) for k, v in batch.items()})
            for s, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                s.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / a
        return loss_sum * inv, [g * inv for g in gsum]

    def train_step(params, opt_state: dict, batch: dict):
        params.requires_grad_()
        loss, grads = grads_of(params, batch)
        tree = dict(params.named_parameters())
        grads = _compress_as_reference(dict(zip(tree, grads)), comp_cfg, every)
        _, opt_state, metrics = apply_updates(opt_cfg, tree, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def _microbatch(t: torch.Tensor, i: int, a: int) -> torch.Tensor:
    """The ``i``-th of ``a`` microbatches of ``t``'s rows: a contiguous
    slice; of a DTensor, each rank's ``i``-th slice of its own rows, so a
    microbatch keeps the batch's split (a contiguous global slice would
    gather the batch).  Either way the ``a`` microbatches are the batch,
    and their summed gradients the same."""

    if not isinstance(t, DTensor):
        n = t.shape[0] // a
        return t[i * n: (i + 1) * n]
    pl = list(t.placements)
    return on_local_shards(lambda x: x[i * (x.shape[0] // a): (i + 1) * (x.shape[0] // a)],
                           pl, (pl,), t)


def _compress_as_reference(grads: dict, cfg: CompressionConfig, every: int = 1) -> dict:
    """Cross-pod gradient compression (identity when disabled), with the
    error dropped each step as the reference's step drops it.  Compression
    scales each row (first axis) of a leaf, and the reference stacks a
    per-layer leaf on L (the hybrid's on (G, E), its flat layer i being
    ``[i // E, i % E]``), so there a row is a leaf name's ``every``
    consecutive layers (E for the hybrid, else 1): the per-layer leaves
    (``layers.<i>.<name>``, the encoder-decoder's ``encoder.<i>.<name>``
    and ``decoder.<i>.<name>``) go in a group at a time, stacked to
    (1, every, ...), and come out split back; any other leaf (embedding,
    head, the hybrid's ``shared`` block) keeps its own first axis.  One
    group at a time, so compression's f32 transients are a group's."""

    if not cfg.enabled:
        return grads
    rows: dict[tuple, list[str]] = {}
    out = {}
    for k, g in grads.items():
        stack, i, name = (k.split(".", 2) + ["", ""])[:3]
        if stack in ("layers", "encoder", "decoder"):
            rows.setdefault((stack, int(i) // every, name), []).append(k)
        else:
            out[k] = compress_tree({k: g}, None, cfg)[0][k]
    for ks in rows.values():
        row = torch.stack([grads[k] for k in ks])[None]
        out.update(zip(ks, compress_tree({"row": row}, None, cfg)[0]["row"][0]))
    return {k: out[k] for k in grads}


def make_prefill_step(model: ModelApi):
    def prefill_step(params, batch: dict):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model: ModelApi):
    def serve_step(params, cache, tokens: torch.Tensor, pos: int):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        # greedy; a vocab split over the mesh is gathered first: DTensor's
        # argmax over a split dim reads scalars back in some torch versions
        # (which a fake tensor cannot) and gathers in others
        next_tok = torch.argmax(constrain(logits[:, -1, :], "batch", None), dim=-1)
        return next_tok[:, None], logits, new_cache

    return serve_step
