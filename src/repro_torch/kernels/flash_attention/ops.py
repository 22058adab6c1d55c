"""Public wrappers of the ``flash_attention`` kernel.

* :func:`flash_attention_op` — kernel layout, q (B, H, Sq, hd) and k/v
  (B, KV, Sk, hd) -> (B, H, Sq, hd);
* :func:`flash_attention_bshd` — model layout, q (B, S, H, hd) and k/v
  (B, S, KV, hd) -> (B, S, H, hd), with no transposes: the kernel takes
  each tensor's strides.

On a CUDA tensor they launch the hand-written kernel
(``csrc/flash_attention.cu``) on the current stream, and raise if it cannot
be built or launched; on a CPU tensor they run the plain torch version
(:mod:`repro_torch.kernels.flash_attention.ref`).  There is no fallback
from the card to the plain version.

The kernel masks ragged tiles itself, so any sequence length works, and
``block_q``/``block_k`` (kept for the reference's signature, which needs
them to divide the sequence) cannot change the result.

``launches["flash_attention"]`` counts kernel launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import math

import torch

from . import ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def _check(q, k, v, seq_dim: int, head_dim: int, block_q: int, block_k: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, hd = q.shape[0], q.shape[3]
    h, kv = q.shape[head_dim], k.shape[head_dim]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if kv == 0 or h % kv != 0:
        raise ValueError(f"heads {h} not divisible by kv heads {kv}")
    if q.shape[seq_dim] == 0 or k.shape[seq_dim] == 0:
        raise ValueError("empty sequence")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"blocks ({block_q}, {block_k}) must be positive")
    if q.device.type == "cuda" and hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")


def _launch(q, k, v, *, causal: bool, scale: float, seq_dim: int, head_dim: int):
    from .kernel import load  # builds with nvcc on first use

    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = load()
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(head_dim), t.stride(seq_dim)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            q.shape[0], q.shape[head_dim], k.shape[head_dim], q.shape[seq_dim],
            k.shape[seq_dim], q.shape[3], scale, int(causal), *strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches["flash_attention"] += 1
    return out


def _run(q, k, v, causal, scale, block_q, block_k, seq_dim, head_dim):
    _check(q, k, v, seq_dim, head_dim, block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        if seq_dim == 2:
            return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal, scale=scale)
        return out.transpose(1, 2).contiguous()
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, scale=float(scale), seq_dim=seq_dim,
                       head_dim=head_dim)
    raise ValueError(f"no flash_attention kernel for device {q.device}")


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, scale: float | None = None,
                       block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """(B, H, Sq, hd) x (B, KV, Sk, hd)^2 -> (B, H, Sq, hd)."""

    return _run(q, k, v, causal, scale, block_q, block_k, seq_dim=2, head_dim=1)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Model layout: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd)."""

    return _run(q, k, v, causal, scale, 256, 256, seq_dim=1, head_dim=2)
