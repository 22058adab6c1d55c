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
the same torch code under both.

Activations carry the reference's sharding annotations at its sites
(:func:`~repro_torch.distributed.sharding.constrain`: q/k/v and the
attention output, the decode cache, the MLP hidden, the MoE dispatch and
expert tensors, the Mamba output, the embedding and the logits); without a
mesh, or on plain tensors, they return their input.  Under a mesh, with
DTensor parameters and inputs, what DTensor has no usable rule for runs on
each rank's shards (:func:`on_local_shards`): the self and cross attention
cores (the kernel is a custom op), the 2-d products (laid out as FSDP x
TP), the MoE routing, tables and experts, the embedding lookup (a gather
or a one-hot product), the split-KV decode attention, the cross entropy
over a split vocab, and the Mamba blocks' conv and scan (the ``ssm_scan``
kernel too) on each rank's channels, their ``xz``/``xi``/``delta`` laid out
on ``"inner"`` as the reference's annotations lay them.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (constrain, grad_placements, placements_for,
                                     replicated_like)
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


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def on_local_shards(fn, out_placements, in_placements, *args):
    """``fn`` over each rank's local shards of the DTensors ``args``
    (``local_map``): inputs redistributed to ``in_placements`` (one
    sequence a tensor, ``None`` for another argument), the output laid out
    by ``out_placements`` (a list; a tuple of lists for several outputs),
    the inputs' gradients by ``grad_placements``.  The outputs and the
    gradients leave contiguous: DTensor reshapes a local shard by a view,
    which a transposed shard refuses."""

    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    outs = out_placements if isinstance(out_placements, tuple) else (out_placements,)

    def local(*xs):
        xs = [_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor) and x.requires_grad
              else x for x in xs]
        out = fn(*xs)
        return tuple(o.contiguous() for o in out) if isinstance(out, tuple) else out.contiguous()

    return local_map(local, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements(in_placements, outs),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _block_of(mesh, placements, dim: int) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of tensor dim ``dim`` laid
    out by ``placements``: the dim is split over the mesh dims that shard
    it, in mesh order."""

    block, n = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            block, n = block * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return block, n


def _moved(placements, **dims) -> tuple:
    """Another tensor's placements from ``placements``: ``Shard(d)`` where
    ``placements`` has ``Shard(old)`` and ``dims`` maps ``f"d{old}"`` to
    ``d``, ``Replicate()`` elsewhere (e.g. ``_moved(pl, d0=0)``: the batch
    split alone)."""

    return tuple(Shard(dims[f"d{p.dim}"]) if isinstance(p, Shard) and f"d{p.dim}" in dims
                 else Replicate() for p in placements)


def _matmul(x: torch.Tensor, w: torch.Tensor, axes: int = 1) -> torch.Tensor:
    """Contract ``x``'s last ``axes`` axes with ``w``'s first ones, in x's
    dtype: (..., *in) x (*in, *out) -> (..., *out)."""

    lead, inner = x.shape[: x.dim() - axes], w.shape[:axes]
    x2, w2 = x.reshape(-1, inner.numel()), w.reshape(inner.numel(), -1)
    out = _sharded_mm(x2, w2) if isinstance(x2, DTensor) else x2 @ w2
    return out.reshape(*lead, *w.shape[axes:])


def _sharded_mm(x, w):
    """``x @ w`` of 2-d DTensors on each rank's shards (``local_map``), laid
    out as FSDP x TP lays a product out, mesh dim by mesh dim: rows of x
    split -> w gathered there (FSDP), rows split out; the contraction split
    in either -> both split on it, a partial sum out; columns of w split ->
    columns split out.  DTensor's own strategy for mm may split the
    columns over a mesh dim that does not divide the dims they unflatten
    to (24 heads over 16 ranks), which no view can then take back, and its
    backward would split the weight's gradient so."""

    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    x_pl, w_pl, out_pl = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(0):
            x_pl.append(px), w_pl.append(Replicate()), out_pl.append(Shard(0))
        elif px == Shard(1) or pw == Shard(0):
            x_pl.append(Shard(1)), w_pl.append(Shard(0)), out_pl.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(pw), out_pl.append(pw)
    return on_local_shards(torch.matmul, out_pl, (tuple(x_pl), tuple(w_pl)), x, w)


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

    if x.device.type == "cpu":
        # made at each call: a cached table would be a real tensor that a
        # CPU dry run's FakeTensorMode refuses, or a fake one cached under it
        freqs = torch.as_tensor(rope_frequencies(x.shape[-1], theta), dtype=torch.float32)
    else:
        freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = replicated_like(x, torch.cos(angles)[..., :, None, :])  # broadcast over heads
    sin = replicated_like(x, torch.sin(angles)[..., :, None, :])
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
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
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
        q = constrain(_matmul(x, wcast(cfg, w.wq, x.dtype)), "batch", None, "heads", None)
        cross = functools.partial(_attend_direct, scale=scale, causal=False)
        o = (_attention_on_local_shards(cfg, cross, q, *cross_kv) if isinstance(q, DTensor)
             else cross(q, *cross_kv, n_rep))
        return constrain(_matmul(o, wcast(cfg, w.wo, x.dtype), axes=2), "batch", None, None), None

    q, k, v = _project_qkv(cfg, w, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if isinstance(q, DTensor):
            o = _attention_on_local_shards(
                cfg, lambda q, k, v, r: _self_attention(cfg, q, k, v, causal, scale, r), q, k, v)
        else:
            o = _self_attention(cfg, q, k, v, causal, scale, n_rep)
        new_cache = (k, v)
    else:
        if x.shape[1] != 1:
            raise ValueError("decode path expects one new token")
        ck, cv = kv_cache
        pos = int(cache_position)
        if isinstance(ck, DTensor):
            o, ck, cv = _decode_on_local_shards(cfg, q, k, v, ck, cv, pos, scale)
        else:
            ck[:, pos: pos + 1] = k.to(ck.dtype)
            cv[:, pos: pos + 1] = v.to(cv.dtype)
            s = _scaled_scores(q, ck, n_rep, scale)  # (B,H,1,S_ctx)
            valid = torch.arange(ck.shape[1], device=x.device)[None, None, None, :] <= pos
            s = torch.where(valid, s, NEG_INF)
            p = _softmax_lastdim(s, smax).to(q.dtype)
            o = _gqa_out(p, cv, n_rep)
        new_cache = (ck, cv)

    return constrain(_matmul(o, wcast(cfg, w.wo, x.dtype), axes=2), "batch", None, None), new_cache


def _self_attention(cfg: ModelConfig, q, k, v, causal: bool, scale: float, n_rep: int):
    """Prefill / train attention core: the kernel under ``"kernel"``, else
    the direct or query-chunked torch path."""

    sq = q.shape[1]
    smax = getattr(torch, cfg.softmax_dtype)
    if cfg.attention_impl == "kernel":
        return flash_attention_bshd(q, k, v, causal=causal, scale=scale)
    if sq <= ATTN_DIRECT_MAX_SEQ or sq % min(ATTN_Q_CHUNK, sq):
        return _attend_direct(q, k, v, n_rep, scale, causal, smax=smax)
    return _attend_chunked(q, k, v, n_rep, scale, causal, smax=smax)


def _attention_on_local_shards(cfg: ModelConfig, attend, q, k, v):
    """``attend(q, k, v, n_rep)`` (self attention, :func:`_self_attention`,
    or cross attention, :func:`_attend_direct`) on each rank's shards
    (``local_map``): attention is independent over batch rows and heads,
    so a rank attends its rows with its q heads.  The kernel is a custom op
    with no DTensor sharding rule, and DTensor's search for a strategy of
    the torch path's 5-d einsums does not end on a 3-d mesh.  Where the q
    heads are split over a mesh dim that the kv heads are not (fewer kv
    heads than ranks), a rank takes the kv heads its q heads read, and
    attends as MHA."""

    mesh = q.device_mesh
    q_pl = placements_for(q.shape, ("batch", None, "heads", None), mesh)
    kv_pl = placements_for(k.shape, ("batch", None, "kv_heads", None), mesh)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    select = [i for i in head_dims if kv_pl[i] != Shard(2)]
    if select and select != head_dims:
        raise NotImplementedError(f"q heads on mesh dims {head_dims}, kv heads on "
                                  f"{[i for i in head_dims if i not in select]} only")

    def core(q, k, v):
        if not select:
            return attend(q, k, v, n_rep)
        block = 0
        for i in select:  # the rank's block of q heads, in mesh order
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        heads = block * q.shape[2] + torch.arange(q.shape[2], device=q.device)
        idx = heads // n_rep
        return attend(q, k.index_select(2, idx), v.index_select(2, idx), 1)

    return on_local_shards(core, list(q_pl), (q_pl, kv_pl, kv_pl), q, k, v)


def _decode_on_local_shards(cfg: ModelConfig, q, k, v, ck, cv, pos: int, scale: float):
    """One decode step of attention against a cache whose sequence is split
    over the mesh (``cache_seq``; flash-decoding's split-KV scheme), each
    rank on its own shards (``local_map``): the rank that holds position
    ``pos`` writes the new k/v into its shard in place; every rank scores
    the token's heads against its slice of the sequence; the softmax takes
    the max and the sum over all slices (``Partial("max")``, then
    ``Partial("sum")``); each rank's share of ``P V`` is summed.  The
    probabilities are the unsharded path's, ``exp(s - max) / sum``, cast to
    q's dtype before ``P V``.  DTensor's search for a strategy of the
    scores' 5-d einsum does not end on a 3-d mesh, hence the local maps.
    Returns (out (B,1,H,hd), ck, cv)."""

    mesh = ck.device_mesh
    ck = constrain(ck, "batch", "cache_seq", None, None)
    cv = constrain(cv, "batch", "cache_seq", None, None)
    c_pl = tuple(ck.placements)
    seq_dims = [i for i, p in enumerate(c_pl) if p == Shard(1)]
    # the token's k/v and q: batch split as the cache's, heads whole
    row_pl = [Shard(0) if p == Shard(0) else Replicate() for p in c_pl]
    s_l = ck.to_local().shape[1]
    first = _block_of(mesh, c_pl, 1)[0] * s_l  # the rank's first position
    if first <= pos < first + s_l:
        for cache, new in ((ck, k), (cv, v)):
            cache.to_local()[:, pos - first: pos - first + 1] = \
                new.to(cache.dtype).redistribute(mesh, row_pl).to_local()
    else:  # every rank takes part in the redistributions
        for new in (k, v):
            new.redistribute(mesh, row_pl)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    smax = getattr(torch, cfg.softmax_dtype)

    def scores(q, ck):
        s = _scaled_scores(q, ck, n_rep, scale)  # (B,H,1,S_l)
        valid = first + torch.arange(ck.shape[1], device=ck.device) <= pos
        return torch.where(valid[None, None, None, :], s, NEG_INF)

    def exps(q, ck, m):
        return torch.exp((scores(q, ck).float() - m).to(smax))

    def reduced(op):
        return [Partial(op) if i in seq_dims else p for i, p in enumerate(row_pl)]

    q = q.redistribute(mesh, row_pl)
    m = on_local_shards(lambda q, ck: scores(q, ck).float().amax(-1, keepdim=True),
                        reduced("max"), (row_pl, c_pl), q, ck).redistribute(mesh, row_pl)
    denom = on_local_shards(
        lambda q, ck, m: torch.sum(exps(q, ck, m).float(), dim=-1, keepdim=True),
        reduced("sum"), (row_pl, c_pl, row_pl), q, ck, m).redistribute(mesh, row_pl)
    o = on_local_shards(
        lambda q, ck, cv, m, denom: _gqa_out((exps(q, ck, m) / denom.to(smax)).to(q.dtype),
                                             cv, n_rep),
        reduced("sum"), (row_pl, c_pl, c_pl, row_pl, row_pl), q, ck, cv, m, denom)
    return constrain(o, "batch", None, "heads", None), ck, cv


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def mlp(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    h = constrain(_matmul(x, wcast(cfg, w.w1, x.dtype)), "batch", None, "mlp")
    if cfg.swiglu:
        h = F.silu(h) * constrain(_matmul(x, wcast(cfg, w.w3, x.dtype)), "batch", None, "mlp")
    else:
        h = F.gelu(h, approximate="tanh")
    return constrain(_matmul(h, wcast(cfg, w.w2, x.dtype)), "batch", None, None)


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
    xg, router = x.reshape(b, s // g, g, d).float(), wcast(cfg, w.router, torch.float32)
    # DTensor's own strategy for this product gathers the whole batch
    route = functools.partial(_route, k=k)
    if isinstance(xg, DTensor):
        # each token routes alone, so a rank routes its batch rows; the
        # sort's backward scatters into a plain tensor in some torch versions
        logits = _matmul(xg, router)
        pl = [Shard(0) if p == Shard(0) else Replicate() for p in logits.placements]
        return (*on_local_shards(route, (pl, pl, pl), (pl,), logits), cap)
    return (*route(xg @ router), cap)


def _route(logits: torch.Tensor, k: int):
    """(gate_vals, gate_idx, slot) of router logits (B, NG, g, E) f32."""

    b, ng, g, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index (jax.lax.top_k's order): a stable sort
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    # exclusive count of earlier choices of the same expert, over the
    # group's (token, rank) pairs in token-major order
    onehot = F.one_hot(gate_idx, e).reshape(b, ng, g * k, e)
    earlier = (torch.cumsum(onehot, dim=2) - onehot).reshape(b, ng, g, k, e)
    slot = torch.gather(earlier, -1, gate_idx[..., None])[..., 0]
    return gate_vals, gate_idx, slot


def moe_mlp(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """Top-k capacity-dropped MoE with routing groups: tokens reach their
    experts' capacity slots through a one-hot dispatch tensor (B, NG, g, E,
    C) and come back through the combine tensor (the same with the gate
    values), both in ``moe_dispatch_dtype`` and cast to the activation dtype
    for the products, as the reference's einsums.  Each slot holds at most
    one token, so the dispatch copies values exactly.  Every expert runs on
    its ``C`` slots whether they are filled or not."""

    b, s, d = x.shape
    gate_vals, gate_idx, slot, cap = moe_routing(cfg, w, x)
    g = slot.shape[2]
    tables = functools.partial(_dispatch_combine, e=cfg.n_experts, cap=cap,
                               ddt=getattr(torch, cfg.moe_dispatch_dtype))
    if isinstance(slot, DTensor):
        # per token too: a rank builds its rows' tables, and DTensor's
        # strategy for the einsums cannot differ between meshes on the card
        # and on the CPU
        pl = list(slot.placements)
        dispatch, combine = on_local_shards(tables, (pl, pl), (pl, pl, pl),
                                            gate_vals, gate_idx, slot)
    else:
        dispatch, combine = tables(gate_vals, gate_idx, slot)
    dispatch = constrain(dispatch, "batch", None, None, "experts", None)

    xg = x.reshape(b, s // g, g, d)
    weights = (w.w1, w.w3 if cfg.swiglu else None, w.w2)
    if isinstance(x, DTensor):
        out = _experts_on_local_shards(cfg, xg, dispatch, combine, weights)
    else:
        out = _experts(cfg, xg, dispatch, combine, *weights)
    return constrain(out.reshape(b, s, d), "batch", None, None)


def _dispatch_combine(gate_vals, gate_idx, slot, *, e: int, cap: int, ddt: torch.dtype):
    """The one-hot dispatch and the gate-weighted combine tables (B, NG, g,
    E, C) in ``ddt`` of a routing."""

    kept = F.one_hot(gate_idx, e).float() * (slot < cap)[..., None]  # (B,NG,g,k,E)
    # a dropped choice's slot is cap, a class cut off below
    cap_slot = F.one_hot(torch.clamp(slot, max=cap), cap + 1)[..., :cap].float()
    dispatch = torch.einsum("bngke,bngkc->bngec", kept, cap_slot).to(ddt)
    combine = torch.einsum("bngke,bngkc->bngec", kept * gate_vals[..., None],
                           cap_slot).to(ddt)
    return dispatch, combine


def _experts(cfg: ModelConfig, xg, dispatch, combine, w1, w3, w2) -> torch.Tensor:
    """Dispatch -> expert FFNs -> combine, (B, NG, g, D) -> (B, NG, g, D)."""

    dt = xg.dtype
    ein = constrain(torch.einsum("bngd,bngec->bnecd", xg, dispatch.to(dt)),
                    "batch", None, "experts", None, None)
    h = constrain(torch.einsum("bnecd,edf->bnecf", ein, wcast(cfg, w1, dt)),
                  "batch", None, "experts", None, "mlp")
    if cfg.swiglu:
        h = F.silu(h) * constrain(torch.einsum("bnecd,edf->bnecf", ein, wcast(cfg, w3, dt)),
                                  "batch", None, "experts", None, "mlp")
    else:
        h = F.gelu(h, approximate="tanh")
    eout = constrain(torch.einsum("bnecf,efd->bnecd", h, wcast(cfg, w2, dt)),
                     "batch", None, "experts", None, None)
    return torch.einsum("bnecd,bngec->bngd", eout, combine.to(dt))


def _experts_on_local_shards(cfg: ModelConfig, xg, dispatch, combine, weights):
    """:func:`_experts` on each rank's shards (``local_map``): a rank's
    batch rows against its experts (EP: experts on ``model``) or its slice
    of every expert's hidden dim (experts that do not divide the axis:
    ``mlp`` on ``model``), the weights' embed dim gathered first (FSDP),
    the output a partial sum over the model axis.  DTensor's einsum
    decomposes into views that its backward applies to gradient shards
    laid out otherwise (aten.view of a non-contiguous local shard), so the
    products run on plain local tensors."""

    mesh = xg.device_mesh
    x_pl = placements_for(xg.shape, ("batch", None, None, None), mesh)
    d_pl = placements_for(dispatch.shape, ("batch", None, None, "experts", None), mesh)
    w1, w3, w2 = weights
    w_in = placements_for(w1.shape, ("experts", None, "mlp"), mesh)
    w_out = placements_for(w2.shape, ("experts", "mlp", None), mesh)
    out_pl = [xp if isinstance(xp, Shard) else Partial() if isinstance(wp, Shard) else xp
              for xp, wp in zip(x_pl, w_in)]
    in_pl = (x_pl, d_pl, d_pl, w_in, w_in if w3 is not None else None, w_out)
    return on_local_shards(functools.partial(_experts, cfg), out_pl, in_pl,
                           xg, dispatch, combine, w1, w3, w2)


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


def _state_or_zeros(h, x: torch.Tensor, n: int) -> torch.Tensor:
    """The scan's starting state in f32: ``h``, or zeros (B, C, N) for
    ``x`` (B, S, C) when there is none."""

    if h is not None:
        return h.float()
    return torch.zeros(x.shape[0], x.shape[2], n, dtype=torch.float32, device=x.device)


def _ssm_scan_fused_m1(cfg: ModelConfig, w, xi: torch.Tensor, h0, chunk: int, lay=None):
    """Mamba-1 scan with x_proj, dt_proj and softplus run inside each chunk
    (perf lever ``mamba_fused_proj``), the chunk recomputed in the backward
    pass: the full-sequence f32 ``delta`` (B,S,DI) and the (B,S,dr+2n)
    projection never exist, only one chunk's.  Positions past the true
    length get delta 0 (a = 1, bx = 0), so a padded last chunk leaves the
    state as it was; a pad of x alone would not, since softplus(dt_bias) is
    not 0.  ``h0`` ``None`` starts from zeros.  Under a mesh (``lay``) each
    chunk's x_proj product is summed over the split channels, one
    all-reduce a chunk, and the rest of the chunk runs on each rank's
    channels."""

    s = xi.shape[1]
    pad = (-s) % chunk
    if pad:
        xi = _on_layout(lay, lambda t: F.pad(t, (0, 0, 0, pad)), "i", ("i",), xi)
    A = -torch.exp(w.A_log.float())  # (DI,N)
    h, ys = h0, []
    for off in range(0, s + pad, chunk):
        y, h = checkpointed(_fused_step, cfg, w, lay, h, xi[:, off: off + chunk], off, s, A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def _fused_step(cfg: ModelConfig, w, lay, h, xc, off: int, s: int, A):
    """One chunk of :func:`_ssm_scan_fused_m1`: its x_proj product, then
    :func:`_fused_chunk_m1`."""

    return _on_layout(lay, functools.partial(_fused_chunk_m1, cfg, off=off, s=s), ("i", "h"),
                      ("h", "i", "rows", "cols", "vec", "vec"),
                      h, xc, _matmul(xc, w.x_proj), w.dt_proj, w.dt_bias, A)


def _fused_chunk_m1(cfg: ModelConfig, h, xc, proj, dt_proj, dt_bias, A, *, off: int, s: int):
    """A chunk of :func:`_ssm_scan_fused_m1` from its x_proj product
    ``proj``: dt_proj and softplus, then :func:`_scan_chunk`."""

    n, dr = cfg.ssm_state, cfg.dt_rank_
    delta_r, B_c, C_c = proj.split([dr, n, n], dim=-1)
    delta = F.softplus(_matmul(delta_r, dt_proj).float() + dt_bias.float())
    valid = (off + torch.arange(xc.shape[1], device=xc.device) < s)[None, :, None]
    delta = torch.where(valid, delta, 0.0)
    return _scan_chunk(_state_or_zeros(h, xc, n), delta, B_c.float(), C_c.float(), xc,
                       A_full=A)


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


@dataclasses.dataclass(frozen=True)
class _SSMLayout:
    """A Mamba block's placements under a mesh, from its (B, S, d_inner)
    activations' ``("batch", None, "inner")``: the conv and the scan are
    independent channel by channel, so each rank runs them on its block
    of d_inner."""

    i: tuple  # (B,S,DI) x, z, delta, y; the Mamba-1 conv window (B,K-1,DI)
    rows: tuple  # the batch split alone: the block input, B, C, the x_proj product
    h: tuple  # (B,DI,N) the state
    cols: tuple  # (*, DI): conv_w, dt_proj
    vec: tuple  # (DI, ...): conv_b, dt_bias, D, A_log, out_norm
    whole: tuple  # gathered: in_proj, the Mamba-2's conv and head vectors
    lo: int  # the rank's first channel
    ranks: int  # the blocks d_inner splits into


def _ssm_layout(cfg: ModelConfig, x: torch.Tensor, unit: int = 1) -> _SSMLayout:
    """The layout of a block over ``x``; where d_inner's blocks would cut
    a unit of ``unit`` channels (a Mamba-2 head), d_inner is not split and
    every rank runs every channel."""

    mesh = x.device_mesh
    i = placements_for((x.shape[0], x.shape[1], cfg.d_inner), ("batch", None, "inner"), mesh)
    block, ranks = _block_of(mesh, i, 2)
    if (cfg.d_inner // ranks) % unit:
        i, block, ranks = _moved(i, d0=0), 0, 1
    return _SSMLayout(i=i, rows=_moved(i, d0=0), h=_moved(i, d0=0, d2=1), cols=_moved(i, d2=1),
                      vec=_moved(i, d2=0), whole=(Replicate(),) * mesh.ndim,
                      lo=block * (cfg.d_inner // ranks), ranks=ranks)


def _on_layout(lay: _SSMLayout | None, fn, outs, ins: tuple, *args):
    """``fn(*args)`` on plain tensors (``lay`` ``None``); under a mesh on
    each rank's shards (:func:`on_local_shards`), the arguments and the
    outputs laid out by the ``lay`` fields that ``ins`` and ``outs`` (a
    name, or a tuple of names for several outputs) name; a ``None``
    argument passes as it is."""

    if lay is None:
        return fn(*args)
    out_pl = (tuple(list(getattr(lay, o)) for o in outs) if isinstance(outs, tuple)
              else list(getattr(lay, outs)))
    in_pl = tuple(None if a is None else getattr(lay, k) for k, a in zip(ins, args, strict=True))
    return on_local_shards(fn, out_pl, in_pl, *args)


def mamba1_block(cfg: ModelConfig, w, x: torch.Tensor, state: SSMState | None = None):
    """Mamba-1 (S6) block.  x: (B,S,D).  With ``state`` and S == 1 it runs one
    decode step, updating the conv window and the hidden state.  Under
    ``mamba_fused_proj`` a multi-token step runs :func:`_ssm_scan_fused_m1`,
    which comes before ``ssm_impl`` as in the reference: a fused prefill
    never reaches the ``ssm_scan`` kernel, in either package.

    Under a mesh (DTensor ``x``) each rank runs its block of d_inner
    (:class:`_SSMLayout`): in_proj's columns are split contiguously, so x's
    channels and z's lie on other ranks; a rank takes its channels of both
    from the gathered weight or the gathered product (:func:`_in_proj_of`).
    x_proj contracts over the split channels: its product (delta_r, B, C)
    is summed over them, one all-reduce a layer, before the scan."""

    s = x.shape[1]
    lay = _ssm_layout(cfg, x) if isinstance(x, DTensor) else None
    prepend = state.conv if state is not None else None
    h0 = state.h if state is not None else None
    xi, z, conv_tail = _on_layout(lay, functools.partial(_m1_in, lo=lay.lo if lay else 0),
                                  ("i", "i", "i"), ("rows", "whole", "cols", "vec", "i"),
                                  *_in_proj_of(lay, x, w.in_proj), w.conv_w, w.conv_b, prepend)
    if cfg.mamba_fused_proj and s > 1:
        y, h_last = _ssm_scan_fused_m1(cfg, w, xi, h0, min(cfg.scan_chunk, s), lay)
    else:
        y, h_last = _on_layout(lay, functools.partial(_m1_scan, cfg), ("i", "h"),
                               ("i", "rows", "cols", "vec", "vec", "h"),
                               xi, _matmul(xi, w.x_proj), w.dt_proj, w.dt_bias, w.A_log, h0)
    y = _on_layout(lay, _m1_gate, "i", ("i", "i", "i", "vec"), y, xi, z, w.D)
    return constrain(_matmul(y, w.out_proj), "batch", None, None), SSMState(conv=conv_tail,
                                                                          h=h_last)


def _in_proj_of(lay: _SSMLayout | None, x, in_proj) -> tuple:
    """What a Mamba block's ranks take of in_proj: ``(x, in_proj)``, the
    weight gathered, each rank multiplying by its channels' columns; or,
    in a decode step (one token a row), ``(x @ in_proj, None)``, the
    product split as tensor parallelism splits it and then gathered: a few
    rows' bytes, not the weight's."""

    if lay is None or x.shape[1] > 1:
        return x, in_proj
    return _matmul(x, in_proj), None


def _m1_in(x, in_proj, conv_w, conv_b, prepend, *, lo: int = 0):
    """A Mamba-1 block's x, after its causal conv, and z (B,S,C), and the
    conv window, over channels [lo, lo + C) of d_inner, C being conv_w's
    (all of them, or a rank's block); ``in_proj`` ``None``: ``x`` is
    in_proj's whole product."""

    dl = conv_w.shape[1]
    if in_proj is None:
        di = x.shape[-1] // 2
        xi, z = x[..., lo: lo + dl], x[..., di + lo: di + lo + dl]
    else:
        di = in_proj.shape[1] // 2
        if dl != di:  # the rank's channels of x and of z
            in_proj = torch.cat([in_proj[:, lo: lo + dl], in_proj[:, di + lo: di + lo + dl]],
                                dim=1)
        xi, z = _matmul(x, in_proj).chunk(2, dim=-1)
    xi, tail = _causal_conv1d(xi, conv_w, conv_b, prepend)
    return xi, z, tail


def _m1_scan(cfg: ModelConfig, xi, proj, dt_proj, dt_bias, A_log, h0):
    """A Mamba-1 block's scan from its x_proj product ``proj``
    (B,S,dr+2n): delta, then one decode step (S == 1), the ``ssm_scan``
    kernel (``ssm_impl="kernel"``, from h = 0) or the chunked torch scan
    from ``h0`` (``None``: zeros).  Returns (y, h_last)."""

    s, n, dr = xi.shape[1], cfg.ssm_state, cfg.dt_rank_
    delta_r, B_ssm, C_ssm = proj.split([dr, n, n], dim=-1)
    delta = F.softplus(_matmul(delta_r, dt_proj).float() + dt_bias.float())  # (B,S,DI)
    A = -torch.exp(A_log.float())  # (DI,N)
    B32, C32 = B_ssm.float().contiguous(), C_ssm.float().contiguous()
    if s == 1:
        return _ssm_step(delta, B32, C32, xi, _state_or_zeros(h0, xi, n), A_full=A)
    if cfg.ssm_impl == "kernel":
        if h0 is not None:
            raise ValueError("the scan kernel starts from h = 0; a multi-token "
                             "step from a state needs ssm_impl='torch'")
        # block_d from the channels here: a rank's block under a mesh
        return ssm_scan_op(delta, B32, C32, xi.contiguous(), A, block_d=min(512, xi.shape[2]),
                           chunk=min(cfg.scan_chunk, s))
    return _ssm_scan(delta, B32, C32, xi, _state_or_zeros(h0, xi, n), min(cfg.scan_chunk, s),
                     A_full=A)


def _m1_gate(y, xi, z, D):
    return (y + xi * D[None, None, :].to(xi.dtype)) * F.silu(z)


# ---------------------------------------------------------------------------
# Mamba-2 block (the hybrid family): SSD with a scalar decay per head
# ---------------------------------------------------------------------------

def mamba2_block(cfg: ModelConfig, w, x: torch.Tensor, state: SSMState | None = None):
    """Mamba-2 (SSD) block: heads of ``mamba_headdim`` channels share B and
    C, and A is a scalar per head; heads are contiguous channel blocks of
    the (B, S, d_inner) activation.  x: (B,S,D).  With ``state`` and S == 1
    it runs one decode step, updating the conv window (over x, B and C
    together) and the hidden state.

    Under a mesh (DTensor ``x``) each rank runs its block of d_inner, whole
    heads (:class:`_SSMLayout`; every head where they do not divide over
    the ranks): in_proj's columns (z, x, B, C and the head
    deltas) and the conv's (x, B and C) are split off the head
    boundaries, so a rank takes its heads' columns, with B and C whole, of
    the gathered weights or product (:func:`_in_proj_of`); the conv window
    over all channels comes from the last inputs, the same on every
    rank.  The output norm sums squares over
    the split channels, one all-reduce a layer."""

    lay = _ssm_layout(cfg, x, cfg.mamba_headdim) if isinstance(x, DTensor) else None
    mix = functools.partial(_m2_mix, cfg, lo=lay.lo if lay else 0,
                            channels=cfg.d_inner // (lay.ranks if lay else 1))
    y, h_last, conv_tail = _on_layout(
        lay, mix, ("i", "h", "rows"),
        ("rows", "whole", "whole", "whole", "rows", "whole", "whole", "whole", "h"),
        *_in_proj_of(lay, x, w.in_proj), w.conv_w, w.conv_b,
        state.conv if state is not None else None,
        w.dt_bias, w.A_log, w.D, state.h if state is not None else None)
    if lay is None:
        y = rms_norm(y, w.out_norm, cfg.norm_eps)
    else:
        y = _rms_norm_on_local_shards(lay, y, w.out_norm, cfg.norm_eps, cfg.d_inner)
    return constrain(_matmul(y, w.out_proj), "batch", None, None), SSMState(conv=conv_tail,
                                                                          h=h_last)


def _m2_mix(cfg: ModelConfig, x, in_proj, conv_w, conv_b, prepend, dt_bias, A_log, D, h0, *,
            lo: int, channels: int):
    """A Mamba-2 block up to its output norm over channels [lo, lo +
    channels) of d_inner (whole heads): z, x, B, C and the heads' deltas
    from in_proj (``None``: ``x`` is its whole product), the causal conv
    over x, B and C, the scan (one decode step when S == 1) from ``h0``
    (``None``: zeros) and the gate.  Returns (y (B,S,C), h_last (B,C,N)
    f32, the conv window (B,K-1,DI+2N))."""

    di, n, p = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim
    s, k = x.shape[1], conv_w.shape[0]
    heads = slice(lo // p, (lo + channels) // p)
    cols, cw, cb, pre = None, conv_w, conv_b, prepend
    if channels != di:  # the rank's heads of z, x and the deltas; B and C whole
        dev = x.device
        # the conv's channels: x's [0, di), then B and C
        conv_cols = torch.cat([torch.arange(lo, lo + channels, device=dev),
                               torch.arange(di, di + 2 * n, device=dev)])
        # in_proj's: z's [0, di), the conv's from di, the deltas' from 2 di + 2 n
        cols = torch.cat([torch.arange(lo, lo + channels, device=dev), conv_cols + di,
                          torch.arange(heads.start, heads.stop, device=dev) + 2 * di + 2 * n])
        cw, cb = conv_w.index_select(1, conv_cols), conv_b.index_select(0, conv_cols)
        pre = None if prepend is None else prepend.index_select(2, conv_cols)
    if in_proj is None:
        proj = x if cols is None else x.index_select(-1, cols)
    else:
        proj = _matmul(x, in_proj if cols is None else in_proj.index_select(1, cols))
    z, xBC, delta_in = proj.split([channels, channels + 2 * n, heads.stop - heads.start],
                                  dim=-1)
    xBC, tail = _causal_conv1d(xBC, cw, cb, pre)
    if cols is not None:  # the window over every channel, from the last K-1 inputs
        last = x[:, max(0, s - (k - 1)):]
        raw = (last[..., di: 2 * di + 2 * n] if in_proj is None
               else _matmul(last, in_proj[:, di: 2 * di + 2 * n]))
        tail = _conv_window(raw, prepend, k)
    xi, B_ssm, C_ssm = xBC.split([channels, n, n], dim=-1)
    delta = F.softplus(delta_in.float() + dt_bias[heads].float())  # (B,S,H)
    A = -torch.exp(A_log[heads].float())  # (H,)
    h0 = _state_or_zeros(h0, xi, n)
    B32, C32 = B_ssm.float().contiguous(), C_ssm.float().contiguous()
    if s == 1:
        y, h_last = _ssm_step(delta, B32, C32, xi, h0, A_head=A, headdim=p)
    else:
        y, h_last = _ssm_scan(delta, B32, C32, xi, h0, min(cfg.scan_chunk, s), A_head=A,
                              headdim=p)
    y = y + xi * D[heads].repeat_interleave(p)[None, None, :].to(xi.dtype)
    return y * F.silu(z), h_last, tail


def _conv_window(new, prepend, k: int) -> torch.Tensor:
    """The conv window (B, K-1, C) a causal conv leaves over inputs whose
    last K-1 (or fewer) rows are ``new``, after ``prepend`` (``None``:
    zeros)."""

    pad = (torch.zeros(new.shape[0], k - 1, new.shape[2], dtype=new.dtype, device=new.device)
           if prepend is None else prepend.to(new.dtype))
    return torch.cat([pad, new], dim=1)[:, -(k - 1):].clone()


def _rms_norm_on_local_shards(lay: _SSMLayout, x, scale, eps: float, width: int):
    """:func:`rms_norm` over a last dim of ``width`` split as ``lay.i``:
    each rank's sum of squares, summed over the split (a partial sum,
    one all-reduce), then each rank normalises its channels."""

    partial = [Partial() if p == Shard(2) else p for p in lay.i]
    sq = on_local_shards(lambda t: torch.sum(t.float() * t.float(), dim=-1, keepdim=True),
                         partial, (lay.i,), x)

    def normed(t, sq, sc):
        return ((t.float() * torch.rsqrt(sq / width + eps)) * sc.float()).to(t.dtype)

    return on_local_shards(normed, list(lay.i), (lay.i, lay.rows, lay.vec), x, sq, scale)


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

    dt = None
    if cfg.embed_onehot:
        dt = emb.dtype if emb.dtype.itemsize > 1 else dtype_of(cfg)
    if isinstance(emb, DTensor):
        rows = _lookup_on_local_shards(emb, tokens, dt)
    else:
        rows = emb[tokens] if dt is None else _onehot_product(emb, tokens, dt)
    return constrain(rows.to(dtype_of(cfg)), "batch", None, None)


def _onehot_product(table, toks, dt: torch.dtype, inside=None):
    """The one-hot of ``toks`` in ``dt`` times ``table``; the rows where
    ``inside`` is false are zeros."""

    onehot = torch.zeros(*toks.shape, table.shape[0], dtype=dt, device=table.device)
    onehot.scatter_(-1, toks[..., None].long(), 1 if inside is None else inside[..., None].to(dt))
    return onehot @ table.to(dt)


def _lookup_on_local_shards(emb, tokens, onehot_dtype: torch.dtype | None = None):
    """``emb[tokens]`` on each rank's shards (``local_map``): the table's
    embed dim gathered first (FSDP), each rank's tokens looked up in its
    vocab rows (by a one-hot product in ``onehot_dtype`` if given, the
    one-hot of the rank's rows alone), zeros for tokens whose row another
    rank holds, the rows a partial sum over the vocab's mesh dims (one
    rank adds each token's row, the others zeros, so the sum is the row
    exactly).  DTensor's index op has no strategy for a table split on its
    embed dim, and its index_put (the backward) fails on a split table in
    some torch versions; a one-hot made whole would be a plain tensor
    beside DTensors."""

    mesh = emb.device_mesh
    t_pl = placements_for(emb.shape, ("vocab", None), mesh)
    tok_pl = placements_for(tokens.shape, ("batch", None), mesh)
    vocab_dims = [i for i, p in enumerate(t_pl) if p == Shard(0)]
    if any(tok_pl[i] != Replicate() for i in vocab_dims):
        raise NotImplementedError("batch and vocab split over one mesh dim")
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(tok_pl)]
    block, _ = _block_of(mesh, t_pl, 0)  # the rank's block of vocab rows

    def lookup(table, toks):
        local = toks - block * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        safe = torch.where(inside, local, 0)
        if onehot_dtype is not None:
            return _onehot_product(table, safe, onehot_dtype, inside)
        return torch.where(inside[..., None], table[safe], 0)

    return on_local_shards(lookup, out_pl, (t_pl, tok_pl), emb, tokens)


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    head = wcast(cfg, params.tok_emb.T if cfg.tie_embeddings else params.lm_head, x.dtype)
    # DTensor's own strategy for a batch-split x times a head split on both
    # dims replicates both and computes every rank's logits
    logits = _matmul(x, head) if isinstance(x, DTensor) else x @ head
    return constrain(logits, "batch", None, "vocab")


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL in f32 over all positions of the padded vocabulary; labels
    < 0 are masked (padding)."""

    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    if isinstance(logits, DTensor):
        nll = _nll_on_local_shards(logits, safe)
    else:
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def _nll_on_local_shards(logits, labels):
    """``-log_softmax(logits)[labels]`` (f32) with the vocab left split over
    the mesh, each rank on its own slice (``local_map``): the max over the
    vocab (``Partial("max")``), the sum of ``exp(x - max)``
    (``Partial("sum")``), and the label's logit from the rank that holds it
    (the others add 0).  DTensor's log_softmax gathers the whole vocab
    first: (16, 4096, 151,936) f32, 37 GiB a device for qwen3-1.7b's
    train_4k on the 16 x 16 mesh."""

    mesh = logits.device_mesh
    l_pl = placements_for(logits.shape, ("batch", None, "vocab"), mesh)
    vocab_dims = [i for i, p in enumerate(l_pl) if p == Shard(2)]
    row_pl = [Shard(0) if p == Shard(0) else Replicate() for p in l_pl]  # batch split only

    def reduced(op):
        return [Partial(op) if i in vocab_dims else p for i, p in enumerate(row_pl)]

    block, _ = _block_of(mesh, l_pl, 2)  # the rank's block of the vocab

    def picked(x, lab):
        local = lab - block * x.shape[-1]
        inside = (local >= 0) & (local < x.shape[-1])
        got = torch.gather(x.float(), -1, torch.where(inside, local, 0)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    logits = logits.redistribute(mesh, l_pl)
    m = on_local_shards(lambda x: x.float().amax(-1, keepdim=True), reduced("max"), (l_pl,),
                        logits).redistribute(mesh, row_pl).detach()
    total = on_local_shards(
        lambda x, m: torch.sum(torch.exp(x.float() - m), dim=-1, keepdim=True),
        reduced("sum"), (l_pl, row_pl), logits, m).redistribute(mesh, row_pl)
    label = on_local_shards(picked, reduced("sum"), (l_pl, row_pl), logits, labels)
    return (m + torch.log(total))[..., 0] - label.redistribute(mesh, row_pl)
