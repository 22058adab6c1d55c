"""Learning-rate schedules: functions of the step (an int tensor) that
return an f32 scale, computed in f32 as the reference's."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    """Warmup to 1.0 then cosine to ``final_frac``."""

    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return fn


def inverse_sqrt(warmup_steps: int):
    def fn(step):
        s = torch.clamp(_f32(step), min=1.0)
        # a true division: ``int / tensor`` is reciprocal-then-multiply in torch
        w = torch.full_like(s, float(warmup_steps))
        return torch.minimum(s / max(warmup_steps, 1), torch.sqrt(w / s))

    return fn
