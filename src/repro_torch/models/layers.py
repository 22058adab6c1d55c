"""Model building blocks of the port: the dense (GQA attention + SwiGLU or
GELU), Mamba-1 and hybrid (Mamba-2 + shared attention) families, for
serving and training.

Every block is ``f(cfg, w, x, ...)`` over a module ``w`` whose parameters
carry the reference's leaf names (``w.wq``, ``w.in_proj``, ...).  The casts
fall where the reference puts them, since in bf16 they decide whether the
two packages agree: matmuls output in the activation dtype; softmax, norm
and scan statistics are f32; ``delta``, ``B`` and ``C`` are f32 before the
scan.  Prefill attention goes to the ``flash_attention`` kernel and the
Mamba-1 prefill scan to the ``ssm_scan`` kernel under ``"kernel"``; under
``"torch"`` they run the layer's own direct/query-chunked attention and
chunked scan.  The Mamba-2 scan has no kernel in either package: it runs
the chunked scan under both.  On one card there is nothing to shard, so
the reference's sharding annotations have no counterpart here.

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
# perf levers of the reference that wait for a later slice of the port
UNPORTED_LEVERS = ("matmul_weight_dtype", "embed_onehot", "mamba_fused_proj", "param_dtype")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for what this slice does not serve, instead of ignoring it."""

    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.family == "ssm" and cfg.mamba_version != 1:
        raise NotImplementedError("the ssm family is ported with Mamba-1 blocks only")
    if cfg.family == "hybrid" and cfg.mamba_version != 2:
        raise NotImplementedError("the hybrid family is ported with Mamba-2 blocks only")
    for lever in UNPORTED_LEVERS:
        if getattr(cfg, lever):
            raise NotImplementedError(f"{lever}={getattr(cfg, lever)!r} is not ported yet")
    for field in ("attention_impl", "ssm_impl"):
        if getattr(cfg, field) not in IMPLS:
            raise ValueError(f"{field} must be one of {IMPLS}, got {getattr(cfg, field)!r}")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    q, k, v = _matmul(x, w.wq), _matmul(x, w.wk), _matmul(x, w.wv)
    if cfg.qk_norm:
        q = rms_norm(q, w.q_norm, cfg.norm_eps)
        k = rms_norm(k, w.k_norm, cfg.norm_eps)
    return q, k, v


def attention(cfg: ModelConfig, w, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, kv_cache=None, cache_position: int | None = None):
    """GQA attention.

    Prefill (``kv_cache=None``): self attention over ``x``; returns (k, v)
    so prefill can emit a cache.

    Decode (``kv_cache=(k, v)``, each (B, S_ctx, KV, hd)): one new token
    against the cache.  The new k/v are written into the cache in place at
    ``cache_position`` (saving a copy of the cache per step), and the
    updated cache is returned.
    """

    hd = cfg.head_dim_
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)
    smax = getattr(torch, cfg.softmax_dtype)

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

    return _matmul(o, w.wo, axes=2), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def mlp(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    h = _matmul(x, w.w1)
    if cfg.swiglu:
        h = F.silu(h) * _matmul(x, w.w3)
    else:
        h = F.gelu(h, approximate="tanh")
    return _matmul(h, w.w2)


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
    return out, xp[:, xp.shape[1] - (k - 1):, :]


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
    decode step, updating the conv window and the hidden state."""

    b, s, _ = x.shape
    di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_

    xi, z = _matmul(x, w.in_proj).chunk(2, dim=-1)  # (B,S,DI) each
    prepend = state.conv if state is not None else None
    xi, conv_tail = _causal_conv1d(xi, w.conv_w, w.conv_b, prepend)
    h0 = (state.h.float() if state is not None
          else torch.zeros(b, di, n, dtype=torch.float32, device=x.device))

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
    return emb[tokens].to(dtype_of(cfg))


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    head = params.tok_emb.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL in f32 over all positions of the padded vocabulary; labels
    < 0 are masked (padding)."""

    lp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(lp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
