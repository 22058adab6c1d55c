"""Gradient compression: symmetric per-row int8/int4 quantization with
error feedback, applied at the gradient-sync boundary as
quantize -> dequantize (the reference's scheme, on dicts of tensors).

    q, scales = encode(grad + error)
    error = (grad + error) - decode(q, scales)

A row's scale is the max over all of its elements: on a DTensor whose
row is split over the mesh (a dim after the first sharded), DTensor's
max is a partial max that it all-reduces, so the scale is the whole
row's; with every dim after the first whole on a rank (``Replicate`` on
each mesh dim but those of the first dim), no collective is needed.

With ``enabled=False`` ``compress_tree`` is the identity, so the train
step has a single code path.
"""

from __future__ import annotations

import dataclasses

import torch

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    bits: int = 8  # int8 rows
    error_feedback: bool = True


def _rowwise(x: torch.Tensor) -> torch.Tensor:
    """View as (rows, cols) for per-row scaling."""

    if x.dim() <= 1:
        return x.reshape(1, -1)
    return x.reshape(x.shape[0], -1)


def encode(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int quantization (round half to even, clipped to
    +-qmax).  Returns (q int8, scales f32)."""

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = (1 << (bits - 1)) - 1
    rows = _rowwise(x.float())
    scales = torch.amax(torch.abs(rows), dim=1, keepdim=True) / qmax
    scales = torch.clamp(scales, min=1e-12)
    q = torch.clamp(torch.round(rows / scales), -qmax, qmax).to(torch.int8)
    return q.reshape(x.shape), scales.squeeze(1)


def decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    rows = _rowwise(q.float())
    return (rows * scales[:, None]).reshape(q.shape)


def compress_tree(grads: Tree, error: Tree | None, cfg: CompressionConfig):
    """Quantize-dequantize each leaf with error feedback.  Returns
    (grads_for_allreduce, new_error); the identity when disabled."""

    if not cfg.enabled:
        return grads, error
    if error is None:
        error = init_error(grads)
    deq, new_err = {}, {}
    for k, g in grads.items():
        g32 = g.float()
        if cfg.error_feedback:
            g32 = g32 + error[k]
        deq[k] = decode(*encode(g32, cfg.bits))
        new_err[k] = (g32 - deq[k]) if cfg.error_feedback else torch.zeros_like(g32)
    return deq, new_err


def init_error(params: Tree) -> Tree:
    # a DTensor leaf's error is a DTensor laid out as it is
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
