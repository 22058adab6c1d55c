"""Model building blocks of the port: the dense (GQA attention + SwiGLU or
GELU), MoE (top-k routed experts with capacity), encoder-decoder (LayerNorm,
cross attention), Mamba-1 and hybrid (Mamba-2 + shared attention) families,
for serving and training.

Every block is ``f(cfg, w, x, ...)`` over a module ``w`` whose parameters
carry the reference's leaf names (``w.wq``, ``w.in_proj``, ...).  The casts
fall where the reference puts them, since in bf16 they decide whether the
two packages agree: matmuls output in the activation dtype; softmax, norm
and scan statistics are f32; ``delta``, ``B`` and ``C`` are f32 before the
scan; MoE router logits are f32.  Prefill attention goes to the
``flash_attention`` kernel and the Mamba-1 prefill scan to the ``ssm_scan``
kernel under ``"kernel"``; under ``"torch"`` they run the layer's own
direct/query-chunked attention and chunked scan.  Cross attention, the MoE
dispatch and the Mamba-2 scan have no kernel in either package: they run
the same torch code under both.  On one card there is nothing to shard, so
the reference's sharding annotations have no counterpart here.

The reference's perf levers are here too: ``matmul_weight_dtype`` casts a
weight right before its matmul (:func:`wcast`, at the reference's sites
only), ``param_dtype`` stores the dense, MoE and VLM trunk's parameters in
another dtype (:func:`param_dtype_of`), ``embed_onehot`` embeds by a
one-hot product, and ``mamba_fused_proj`` runs a Mamba-1 layer's x_proj and
dt_proj inside each recomputed scan chunk (:func:`_ssm_scan_fused_m1`).

Where the reference wraps a body in ``jax.checkpoint`` (a block, a query
chunk of long attention, a chunk of the scan), the port calls it through
:func:`checkpointed`, which recomputes it in the backward pass when
autograd records and calls it plainly otherwise (serving).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention_bshd
from ..kernels.ssm_scan.ops import ssm_scan_op

ATTN_DIRECT_MAX_SEQ = 1024  # direct path below this, q-chunked above
ATTN_Q_CHUNK = 512
NEG_INF = float(np.finfo(np.float32).min)
IMPLS = ("kernel", "torch")
FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
# the families whose parameters the reference stores in cfg.param_dtype
# (models/transformer.py); its ssm, hybrid and encdec init ignores it
PARAM_DTYPE_FAMILIES = ("dense", "moe", "vlm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a config the port does not run, instead of ignoring a field
    of it."""

    if cfg.family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {cfg.family!r}")
    if cfg.family == "ssm" and cfg.mamba_version != 1:
        raise NotImplementedError("the ssm family is ported with Mamba-1 blocks only")
    if cfg.family == "hybrid" and cfg.mamba_version != 2:
        raise NotImplementedError("the hybrid family is ported with Mamba-2 blocks only")
    if cfg.param_dtype and cfg.family not in PARAM_DTYPE_FAMILIES:
        raise NotImplementedError(
            f"param_dtype={cfg.param_dtype!r} is honoured by the {PARAM_DTYPE_FAMILIES} "
            f"families only (the reference's {cfg.family} family ignores it)")
    for field in ("attention_impl", "ssm_impl"):
        if getattr(cfg, field) not in IMPLS:
            raise ValueError(f"{field} must be one of {IMPLS}, got {getattr(cfg, field)!r}")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    """Storage dtype for parameters (weight-only quantization lever)."""

    return getattr(torch, cfg.param_dtype or cfg.dtype)


def wcast(cfg: ModelConfig, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weight cast right before a matmul (perf lever
    ``matmul_weight_dtype``, e.g. ``"float8_e4m3fn"``; ``None`` leaves it),
    then held in ``dtype``, the dtype the product runs in.  The reference
    multiplies the cast weight with ``preferred_element_type``; torch
    multiplies only operands of one dtype, so the product takes the cast
    values dequantized, with no scale, as the reference's does.  The same
    second cast lets a weight stored in fp8 (``param_dtype``) meet a bf16
    activation."""

    if cfg.matmul_weight_dtype is not None:
        w = w.to(getattr(torch, cfg.matmul_weight_dtype))
    return w.to(dtype)


def checkpointed(fn, *args, **kw):
    """``fn(*args, **kw)``, its activations recomputed in the backward pass
    instead of kept, when autograd records (the reference's
    ``jax.checkpoint``); a plain call under ``no_grad``/inference mode."""

    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def _matmul(x: torch.Tensor, w: torch.Tensor, axes: int = 1) -> torch.Tensor:
    """Contract ``x``'s last ``axes`` axes with ``w``'s first ones, in x's
    dtype: (..., *in) x (*in, *out) -> (..., *out)."""

    lead, inner = x.shape[: x.dim() - axes], w.shape[:axes]
    out = x.reshape(-1, inner.numel()) @ w.reshape(inner.numel(), -1)
    return out.reshape(*lead, *w.shape[axes:])


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """In f32, with the population variance."""

    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once: a copy from pageable host memory would
    # synchronise the stream at every call
    return torch.as_tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Rotates by halves, in f32."""

    freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,H,Sq,Sk) with KV-head grouping."""

    b, sq, h, hd = q.shape
    kv = k.shape[2]
    s = torch.einsum("bqgrk,bsgk->bgrqs", q.reshape(b, sq, kv, n_rep, hd), k)
    return s.reshape(b, h, sq, k.shape[1])


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,H,Sq,Sk) x (B,Sk,KV,hd) -> (B,Sq,H,hd)."""

    b, h, sq, sk = probs.shape
    kv = v.shape[2]
    o = torch.einsum("bgrqs,bsgk->bqgrk", probs.reshape(b, kv, n_rep, sq, sk), v)
    return o.reshape(b, sq, h, v.shape[3])


def _softmax_lastdim(s: torch.Tensor, stats_dtype: torch.dtype) -> torch.Tensor:
    """Softmax with a selectable statistics dtype (``softmax_dtype``): bf16
    keeps the max-subtraction in f32 and sums in f32."""

    if stats_dtype == torch.float32:
        return torch.softmax(s.float(), dim=-1)
    m = torch.amax(s.float(), dim=-1, keepdim=True)
    e = torch.exp((s.float() - m).to(stats_dtype))
    denom = torch.sum(e.float(), dim=-1, keepdim=True)
    return e / denom.to(stats_dtype)


def _scaled_scores(q, k, n_rep, scale):
    """f32 scores: the reference's ``q * scale`` with a NumPy-scalar scale
    promotes bf16 q (and then k) to f32."""

    return _gqa_scores(q.float() * scale, k.float(), n_rep)


def _attend_direct(q, k, v, n_rep, scale, causal, q_offset=0, smax=torch.float32):
    s = _scaled_scores(q, k, n_rep, scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = _softmax_lastdim(s, smax).to(q.dtype)
    return _gqa_out(p, v, n_rep)


def _attend_chunked(q, k, v, n_rep, scale, causal, smax=torch.float32):
    """Exact attention with query chunking: scores stay (B,H,qc,S)."""

    sq = q.shape[1]
    qc = min(ATTN_Q_CHUNK, sq)
    if sq % qc != 0:
        raise ValueError(f"seq {sq} not divisible by query chunk {qc}")
    outs = [checkpointed(_attend_direct, q[:, off: off + qc], k, v, n_rep, scale, causal,
                         q_offset=off, smax=smax) for off in range(0, sq, qc)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA attention layer (prefill / decode)
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, w, x: torch.Tensor):
    q, k, v = (_matmul(x, wcast(cfg, t, x.dtype)) for t in (w.wq, w.wk, w.wv))
    if cfg.qk_norm:
        q = rms_norm(q, w.q_norm, cfg.norm_eps)
        k = rms_norm(k, w.k_norm, cfg.norm_eps)
    return q, k, v


def attention(cfg: ModelConfig, w, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, kv_cache=None, cache_position: int | None = None,
              cross_kv=None):
    """GQA attention.

    Prefill (``kv_cache=None``): self attention over ``x``; returns (k, v)
    so prefill can emit a cache.

    Decode (``kv_cache=(k, v)``, each (B, S_ctx, KV, hd)): one new token
    against the cache.  The new k/v are written into the cache in place at
    ``cache_position`` (saving a copy of the cache per step), and the
    updated cache is returned.

    Cross attention (``cross_kv=(k, v)``, the encoder's projected keys and
    values): no mask, f32 softmax, always the direct path (the reference's
    never reaches its kernel); returns (out, None).
    """

    hd = cfg.head_dim_
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)
    smax = getattr(torch, cfg.softmax_dtype)

    if cross_kv is not None:
        o = _attend_direct(_matmul(x, wcast(cfg, w.wq, x.dtype)), *cross_kv, n_rep, scale,
                           causal=False)
        return _matmul(o, wcast(cfg, w.wo, x.dtype), axes=2), None

    q, k, v = _project_qkv(cfg, w, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        sq = x.shape[1]
        if cfg.attention_impl == "kernel":
            o = flash_attention_bshd(q, k, v, causal=causal, scale=scale)
        elif sq <= ATTN_DIRECT_MAX_SEQ or sq % min(ATTN_Q_CHUNK, sq):
            o = _attend_direct(q, k, v, n_rep, scale, causal, smax=smax)
        else:
            o = _attend_chunked(q, k, v, n_rep, scale, causal, smax=smax)
        new_cache = (k, v)
    else:
        if x.shape[1] != 1:
            raise ValueError("decode path expects one new token")
        ck, cv = kv_cache
        pos = int(cache_position)
        ck[:, pos: pos + 1] = k.to(ck.dtype)
        cv[:, pos: pos + 1] = v.to(cv.dtype)
        s = _scaled_scores(q, ck, n_rep, scale)  # (B,H,1,S_ctx)
        valid = torch.arange(ck.shape[1], device=x.device)[None, None, None, :] <= pos
        s = torch.where(valid, s, NEG_INF)
        p = _softmax_lastdim(s, smax).to(q.dtype)
        o = _gqa_out(p, cv, n_rep)
        new_cache = (ck, cv)

    return _matmul(o, wcast(cfg, w.wo, x.dtype), axes=2), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def mlp(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    h = _matmul(x, wcast(cfg, w.w1, x.dtype))
    if cfg.swiglu:
        h = F.silu(h) * _matmul(x, wcast(cfg, w.w3, x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return _matmul(h, wcast(cfg, w.w2, x.dtype))


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-based grouped dispatch)
# ---------------------------------------------------------------------------

def moe_routing(cfg: ModelConfig, w, x: torch.Tensor):
    """The routing of :func:`moe_mlp` over ``x`` (B, S, D): tokens in groups
    of ``g = min(moe_group_size, S)``, each choosing its top
    ``experts_per_token`` experts; each (token, choice) takes the next slot
    of its expert's buffer of ``cap`` slots in its group, token by token and
    by rank within a token, and is dropped past ``cap``.

    Returns ``(gate_vals, gate_idx, slot, cap)``: the normalised gate
    values (B, NG, g, k) f32, the expert indices (B, NG, g, k), the
    capacity slots (B, NG, g, k; a choice is kept iff its slot < cap) and
    ``cap``."""

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, s)
    if s % g != 0:
        raise ValueError(f"seq {s} not divisible by moe group {g}")
    cap = max(math.ceil(g * k / e * cfg.capacity_factor), 1)
    # f32 logits from the operands' values, as preferred_element_type=f32
    logits = x.reshape(b, s // g, g, d).float() @ wcast(cfg, w.router, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index (jax.lax.top_k's order): a stable sort
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    # exclusive count of earlier choices of the same expert, over the
    # group's (token, rank) pairs in token-major order
    onehot = F.one_hot(gate_idx, e).reshape(b, s // g, g * k, e)
    earlier = (torch.cumsum(onehot, dim=2) - onehot).reshape(b, s // g, g, k, e)
    slot = torch.gather(earlier, -1, gate_idx[..., None])[..., 0]
    return gate_vals, gate_idx, slot, cap


def moe_mlp(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """Top-k capacity-dropped MoE with routing groups: tokens reach their
    experts' capacity slots through a one-hot dispatch tensor (B, NG, g, E,
    C) and come back through the combine tensor (the same with the gate
    values), both in ``moe_dispatch_dtype`` and cast to the activation dtype
    for the products, as the reference's einsums.  Each slot holds at most
    one token, so the dispatch copies values exactly.  Every expert runs on
    its ``C`` slots whether they are filled or not."""

    b, s, d = x.shape
    e = cfg.n_experts
    gate_vals, gate_idx, slot, cap = moe_routing(cfg, w, x)
    g = slot.shape[2]
    ddt = getattr(torch, cfg.moe_dispatch_dtype)
    kept = F.one_hot(gate_idx, e).float() * (slot < cap)[..., None]  # (B,NG,g,k,E)
    # a dropped choice's slot is cap, a class cut off below
    cap_slot = F.one_hot(torch.clamp(slot, max=cap), cap + 1)[..., :cap].float()
    dispatch = torch.einsum("bngke,bngkc->bngec", kept, cap_slot).to(ddt)
    combine = torch.einsum("bngke,bngkc->bngec", kept * gate_vals[..., None],
                           cap_slot).to(ddt)

    dt = x.dtype
    xg = x.reshape(b, s // g, g, d)
    ein = torch.einsum("bngd,bngec->bnecd", xg, dispatch.to(dt))
    h = torch.einsum("bnecd,edf->bnecf", ein, wcast(cfg, w.w1, dt))
    if cfg.swiglu:
        h = F.silu(h) * torch.einsum("bnecd,edf->bnecf", ein, wcast(cfg, w.w3, dt))
    else:
        h = F.gelu(h, approximate="tanh")
    eout = torch.einsum("bnecf,efd->bnecd", h, wcast(cfg, w.w2, dt))
    out = torch.einsum("bnecd,bngec->bngd", eout, combine.to(dt))
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# selective scan (Mamba-1: A per channel and state; Mamba-2: A per head)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SSMState:
    """Recurrent state for decode: conv window + SSM hidden state."""

    conv: torch.Tensor  # (B, d_conv-1, conv channels)
    h: torch.Tensor  # (B, d_inner, state) f32


def _causal_conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   prepend: torch.Tensor | None):
    """Depthwise causal conv over seq.  x: (B,S,C); kernel: (K,C)."""

    k = kernel.shape[0]
    if prepend is None:
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = prepend.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i: i + x.shape[1], :] * kernel[i][None, None, :] for i in range(k))
    out = F.silu(out + bias[None, None, :])
    # the tail is copied: a view would keep the whole (B, S+K-1, C) input
    # alive in the layer's state
    return out, xp[:, xp.shape[1] - (k - 1):, :].clone()


def _assoc_scan(a: torch.Tensor, bx: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h -> a*h + bx, by
    doubling: combine(left, right) = (al*ar, bl*ar + br)."""

    n, off = a.shape[1], 1
    while off < n:
        bx = torch.cat([bx[:, :off], bx[:, :-off] * a[:, off:] + bx[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, bx


def _ssm_scan(delta, B_ssm, C_ssm, xi, h0, chunk, *, A_full=None, A_head=None,
              headdim=1):
    """Chunked selective scan; the (B, chunk, DI, N) expansion exists for one
    chunk at a time, never for the whole sequence.

    delta: (B,S,DI) f32 (Mamba-1) or (B,S,H) f32 (Mamba-2, per head);
    B_ssm/C_ssm: (B,S,N) f32; xi: (B,S,DI); h0: (B,DI,N) f32;
    A_full: (DI,N) f32 (Mamba-1) or A_head: (H,) f32 (Mamba-2, heads of
    ``headdim`` contiguous channels).
    Returns y: (B,S,DI) (xi dtype), h_last: (B,DI,N) f32.
    """

    s = xi.shape[1]
    pad = (-s) % chunk
    if pad:
        # zero padding is exact: delta=0 -> a=exp(0)=1, bx=0 (identity
        # updates that leave h_last untouched); padded y rows are cut off
        delta, B_ssm, C_ssm, xi = (F.pad(t, (0, 0, 0, pad)) for t in (delta, B_ssm, C_ssm, xi))
    h, ys = h0, []
    for off in range(0, s + pad, chunk):
        y, h = checkpointed(_scan_chunk, h, *(t[:, off: off + chunk]
                                              for t in (delta, B_ssm, C_ssm, xi)),
                            A_full=A_full, A_head=A_head, headdim=headdim)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def _scan_chunk(h, d, bm, cm, xc, *, A_full=None, A_head=None, headdim=1):
    """One chunk of :func:`_ssm_scan`: returns (y, h at its last step)."""

    if A_full is not None:
        a = torch.exp(d[..., None] * A_full[None, None])  # (B,chunk,DI,N)
        bx = d[..., None] * bm[:, :, None, :] * xc.float()[..., None]
        a_acc, bx_acc = _assoc_scan(a, bx)
        hs = a_acc * h[:, None] + bx_acc
        # the last state is cloned: a view would keep the chunk's whole
        # (B,chunk,DI,N) expansion alive with it
        return torch.einsum("bldn,bln->bld", hs, cm).to(xc.dtype), hs[:, -1].clone()
    # Mamba-2: the decay is one scalar a head, carried as (B,chunk,H,1,1) and
    # broadcast only where it meets bx (B,chunk,H,P,N).  The reference
    # broadcasts it to (B,chunk,DI,N) first; the products and their order
    # are the same.
    b, l, nh = d.shape
    n = bm.shape[-1]
    a = torch.exp(d * A_head)[..., None, None]
    bx = (d[..., None, None] * bm[:, :, None, None, :]
          * xc.float().reshape(b, l, nh, headdim, 1))
    a_acc, bx_acc = _assoc_scan(a, bx)
    hs = a_acc * h.reshape(b, 1, nh, headdim, n) + bx_acc
    y = torch.einsum("blhpn,bln->blhp", hs, cm).reshape(b, l, nh * headdim)
    return y.to(xc.dtype), hs[:, -1].reshape(b, nh * headdim, n).clone()


def _ssm_scan_fused_m1(cfg: ModelConfig, w, xi: torch.Tensor, h0: torch.Tensor, chunk: int):
    """Mamba-1 scan with x_proj, dt_proj and softplus run inside each chunk
    (perf lever ``mamba_fused_proj``), the chunk recomputed in the backward
    pass: the full-sequence f32 ``delta`` (B,S,DI) and the (B,S,dr+2n)
    projection never exist, only one chunk's.  Positions past the true
    length get delta 0 (a = 1, bx = 0), so a padded last chunk leaves the
    state as it was; a pad of x alone would not, since softplus(dt_bias) is
    not 0."""

    s = xi.shape[1]
    pad = (-s) % chunk
    if pad:
        xi = F.pad(xi, (0, 0, 0, pad))
    A = -torch.exp(w.A_log.float())  # (DI,N)
    h, ys = h0, []
    for off in range(0, s + pad, chunk):
        y, h = checkpointed(_fused_chunk_m1, cfg, w, h, xi[:, off: off + chunk], off, s, A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def _fused_chunk_m1(cfg: ModelConfig, w, h, xc, off: int, s: int, A):
    """One chunk of :func:`_ssm_scan_fused_m1`: its projections, then
    :func:`_scan_chunk`."""

    n, dr = cfg.ssm_state, cfg.dt_rank_
    delta_r, B_c, C_c = _matmul(xc, w.x_proj).split([dr, n, n], dim=-1)
    delta = F.softplus(_matmul(delta_r, w.dt_proj).float() + w.dt_bias.float())
    valid = (off + torch.arange(xc.shape[1], device=xc.device) < s)[None, :, None]
    delta = torch.where(valid, delta, 0.0)
    return _scan_chunk(h, delta, B_c.float(), C_c.float(), xc, A_full=A)


def _ssm_step(delta, B_ssm, C_ssm, xi, h0, *, A_full=None, A_head=None, headdim=1):
    """Single decode step of the scan (S == 1)."""

    if A_full is not None:
        a = torch.exp(delta[:, 0, :, None] * A_full[None])  # (B,DI,N)
        d_di = delta[:, 0]
    else:
        a = torch.exp(delta[:, 0] * A_head[None, :]).repeat_interleave(headdim, -1)[..., None]
        d_di = delta[:, 0].repeat_interleave(headdim, -1)
    bx = d_di[..., None] * B_ssm[:, 0, None, :] * xi.float()[:, 0, :, None]
    h1 = a * h0 + bx
    y = torch.einsum("bdn,bn->bd", h1, C_ssm[:, 0])[:, None].to(xi.dtype)
    return y, h1


def mamba1_block(cfg: ModelConfig, w, x: torch.Tensor, state: SSMState | None = None):
    """Mamba-1 (S6) block.  x: (B,S,D).  With ``state`` and S == 1 it runs one
    decode step, updating the conv window and the hidden state.  Under
    ``mamba_fused_proj`` a multi-token step runs :func:`_ssm_scan_fused_m1`,
    which comes before ``ssm_impl`` as in the reference: a fused prefill
    never reaches the ``ssm_scan`` kernel, in either package."""

    b, s, _ = x.shape
    di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_

    xi, z = _matmul(x, w.in_proj).chunk(2, dim=-1)  # (B,S,DI) each
    prepend = state.conv if state is not None else None
    xi, conv_tail = _causal_conv1d(xi, w.conv_w, w.conv_b, prepend)
    h0 = (state.h.float() if state is not None
          else torch.zeros(b, di, n, dtype=torch.float32, device=x.device))

    if cfg.mamba_fused_proj and s > 1:
        y, h_last = _ssm_scan_fused_m1(cfg, w, xi, h0, min(cfg.scan_chunk, s))
    else:
        delta_r, B_ssm, C_ssm = _matmul(xi, w.x_proj).split([dr, n, n], dim=-1)
        delta = F.softplus(_matmul(delta_r, w.dt_proj).float() + w.dt_bias.float())  # (B,S,DI)
        A = -torch.exp(w.A_log.float())  # (DI,N)
        B32, C32 = B_ssm.float().contiguous(), C_ssm.float().contiguous()
        if s == 1:
            y, h_last = _ssm_step(delta, B32, C32, xi, h0, A_full=A)
        elif cfg.ssm_impl == "kernel":
            if state is not None:
                raise ValueError("the scan kernel starts from h = 0; a multi-token "
                                 "step from a state needs ssm_impl='torch'")
            y, h_last = ssm_scan_op(delta, B32, C32, xi, A, block_d=min(512, di),
                                    chunk=min(cfg.scan_chunk, s))
        else:
            y, h_last = _ssm_scan(delta, B32, C32, xi, h0, min(cfg.scan_chunk, s), A_full=A)
    y = y + xi * w.D[None, None, :].to(x.dtype)
    y = y * F.silu(z)
    return _matmul(y, w.out_proj), SSMState(conv=conv_tail, h=h_last)


# ---------------------------------------------------------------------------
# Mamba-2 block (the hybrid family): SSD with a scalar decay per head
# ---------------------------------------------------------------------------

def mamba2_block(cfg: ModelConfig, w, x: torch.Tensor, state: SSMState | None = None):
    """Mamba-2 (SSD) block: heads of ``mamba_headdim`` channels share B and
    C, and A is a scalar per head; heads are contiguous channel blocks of
    the (B, S, d_inner) activation.  x: (B,S,D).  With ``state`` and S == 1
    it runs one decode step, updating the conv window (over x, B and C
    together) and the hidden state."""

    b, s, _ = x.shape
    di, n, p = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim

    z, xBC, delta_in = _matmul(x, w.in_proj).split([di, di + 2 * n, cfg.mamba_heads], dim=-1)
    prepend = state.conv if state is not None else None
    xBC, conv_tail = _causal_conv1d(xBC, w.conv_w, w.conv_b, prepend)
    xi, B_ssm, C_ssm = xBC.split([di, n, n], dim=-1)

    delta = F.softplus(delta_in.float() + w.dt_bias.float())  # (B,S,H)
    A = -torch.exp(w.A_log.float())  # (H,)
    h0 = (state.h.float() if state is not None
          else torch.zeros(b, di, n, dtype=torch.float32, device=x.device))
    B32, C32 = B_ssm.float().contiguous(), C_ssm.float().contiguous()
    if s == 1:
        y, h_last = _ssm_step(delta, B32, C32, xi, h0, A_head=A, headdim=p)
    else:
        y, h_last = _ssm_scan(delta, B32, C32, xi, h0, min(cfg.scan_chunk, s), A_head=A,
                              headdim=p)
    y = y + xi * w.D.repeat_interleave(p)[None, None, :].to(x.dtype)
    y = rms_norm(y * F.silu(z), w.out_norm, cfg.norm_eps)
    return _matmul(y, w.out_proj), SSMState(conv=conv_tail, h=h_last)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``tokens``, in the activation dtype.  Under
    ``embed_onehot`` a one-hot in the table's dtype times the table: one
    nonzero a row, so the gather's values bit for bit.  The one-hot is
    scattered in place, not made by ``F.one_hot``, whose int64 would take
    four times its (B, S, V) bytes; an fp8 table's product runs in the
    activation dtype (torch multiplies no fp8 operands), which holds its
    values exactly."""

    if not cfg.embed_onehot:
        return emb[tokens].to(dtype_of(cfg))
    dt = emb.dtype if emb.dtype.itemsize > 1 else dtype_of(cfg)
    onehot = torch.zeros(*tokens.shape, emb.shape[0], dtype=dt, device=emb.device)
    onehot.scatter_(-1, tokens[..., None].long(), 1)
    return (onehot @ emb.to(dt)).to(dtype_of(cfg))


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    head = params.tok_emb.T if cfg.tie_embeddings else params.lm_head
    return x @ wcast(cfg, head, x.dtype)


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL in f32 over all positions of the padded vocabulary; labels
    < 0 are masked (padding)."""

    lp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(lp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
