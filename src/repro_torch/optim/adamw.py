"""AdamW with parameters in their own dtype and f32 moments, global-norm
clipping, over dicts of tensors.

The port's copy of the reference's optimizer.  A parameter tree is a dict
``name -> tensor`` (the train step passes ``dict(params.named_parameters())``);
the state mirrors it: ``{"m": {name: f32}, "v": {name: f32}, "step": int32}``.
The numerics are the reference's: scalars rounded to f32 before they meet
a tensor, the bias corrections ``b ** step`` in f32, each parameter
updated in f32 and rounded to its dtype once a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None  # step -> scale


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def init_state(params: Tree) -> dict:
    def zeros():  # a DTensor parameter's moments are DTensors laid out as it is
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(abstract_params: Tree) -> dict:
    """:func:`init_state`'s shapes and dtypes, as meta tensors."""

    def zeros():
        return {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for k, p in abstract_params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_axes(param_axes: dict) -> dict:
    """Moments share the params' logical axes; step is replicated."""

    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the tree's order) of each leaf's f32
    sum of squares."""

    total = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, norm.device) / (norm + _f32(1e-9, norm.device)),
                       max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Tree, grads: Tree, state: dict):
    """One AdamW step.  Returns (params, state, metrics).

    Updates ``params`` and the moments of ``state`` in place, one leaf at
    a time (the clipped f32 gradient of one leaf exists at a time), and
    returns them; the reference returns new trees of the same values."""

    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    dev = gnorm.device
    step = state["step"] + 1
    lr = _f32(cfg.lr, dev) * (cfg.schedule(step) if cfg.schedule is not None else 1.0)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), step.float())
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), step.float())
    for k, p in params.items():
        g = grads[k].float() * scale
        m = state["m"][k].mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v = state["v"][k].mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        del g
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)  # rounded to p's dtype once
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
