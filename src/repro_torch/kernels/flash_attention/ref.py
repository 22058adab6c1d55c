"""Plain torch version of the ``flash_attention`` kernel.

Exact (non-streamed) attention with an f32 softmax, GQA by KV-head
grouping and an optional causal mask from position 0.  Layout matches the
kernel: q (B, H, Sq, hd), k/v (B, KV, Sk, hd) -> out (B, H, Sq, hd) in q's
dtype.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None) -> torch.Tensor:
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if h % kv != 0:
        raise ValueError(f"heads {h} not divisible by kv heads {kv}")
    n_rep = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kv, n_rep, sq, hd).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg * scale, k.float())
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, h, sq, hd).to(q.dtype)
