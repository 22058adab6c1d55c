"""Model configuration of the port's model stack.

A copy of the reference's ``ModelConfig`` with every field, and of
``smoke_variant``.  Two fields take the port's own values:

* ``attention_impl``: ``"kernel"`` (default) runs prefill attention through
  the hand-written ``flash_attention`` kernel on a CUDA tensor and through
  that kernel's plain version on a CPU tensor; ``"torch"`` runs the
  layer's own direct or query-chunked attention.
* ``ssm_impl``: ``"kernel"`` (default) runs the Mamba-1 prefill scan
  through the hand-written ``ssm_scan`` kernel (plain version on the CPU);
  ``"torch"`` runs the layer's chunked scan.

They are the counterparts of the reference's ``"pallas"`` and ``"xla"``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None
    qk_norm: bool = False
    swiglu: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 256  # routing-group tokens (bounds dispatch memory)

    # SSM (Mamba-1/2)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    mamba_version: int = 1
    dt_rank: int | None = None  # default ceil(d_model/16)
    mamba_headdim: int = 64  # mamba-2 head dim
    scan_chunk: int = 256  # chunked-scan length (bounds residual memory)

    # hybrid (Zamba2-style)
    shared_attn_every: int = 0  # shared attention block cadence; 0 = none

    # encoder-decoder (Whisper-style)
    encoder_layers: int = 0
    n_frames: int = 1500  # stubbed conv-frontend output length

    # VLM (InternVL-style)
    n_patches: int = 0  # stubbed ViT patch embeddings prepended to the text

    # numerics / system
    vocab_pad_to: int = 128
    dtype: str = "bfloat16"
    remat: str = "block"  # none | block  (activation checkpoint policy)
    attention_impl: str = "kernel"  # kernel | torch

    # ---- perf levers (hillclimb; defaults = paper-faithful baseline) ----
    # cast weights to this dtype right before matmuls: the FSDP all-gather
    # then moves the casted tensor (fp8 halves collective bytes vs bf16)
    matmul_weight_dtype: str | None = None  # e.g. "float8_e4m3fn"
    # embedding lookup as one-hot matmul instead of gather (avoids GSPMD's
    # "involuntary full rematerialization" replication of the table)
    embed_onehot: bool = False
    # compute Mamba x_proj/dt_proj inside the rematerialized chunk body so
    # the full-sequence f32 delta/(B,S,dr+2n) tensors never materialize
    mamba_fused_proj: bool = False
    # gradient accumulation: split the global batch into microbatches of
    # this many sequences (per step); activation memory scales down ~B/mb
    microbatch: int | None = None
    # softmax statistics dtype: "float32" (baseline) or "bfloat16" (halves
    # attention-score HBM traffic in the XLA path; max-subtraction stays f32)
    softmax_dtype: str = "float32"
    # logical-axis rule overrides, e.g. (("batch", ()),) replicates
    # activation batch over the data axis — for serving, this converts the
    # per-token FSDP weight all-gathers into tiny activation all-reduces
    # (contracting-dim sharded matmuls)
    shard_rules_override: tuple = ()
    # store parameters in this dtype (weight-only quantized serving): the
    # FSDP gathers then move fp8 bytes — unlike matmul_weight_dtype, the
    # cast cannot be hoisted past the collective because storage IS fp8
    param_dtype: str | None = None
    # dtype of the MoE one-hot dispatch/combine tensors (T x E x C each —
    # THE memory elephant in MoE cells; bf16 halves it, routing-group size
    # divides it further)
    moe_dispatch_dtype: str = "float32"
    # selective-scan implementation: "kernel" (kernels/ssm_scan, the f32
    # state carried in registers across the whole sequence) or "torch"
    # (chunked scan)
    ssm_impl: str = "kernel"

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(self.d_model / 16)

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the long_500k cell (SSM state or hybrid w/ O(1) blocks)."""

        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embedding + trunk), for 6ND."""

        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.padded_vocab
        hd = self.head_dim_
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm"):
            attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
            mlp_mult = 3 if self.swiglu else 2
            if self.family == "moe":
                mlp = self.n_experts * mlp_mult * D * F + D * self.n_experts
            else:
                mlp = mlp_mult * D * F
            return emb + L * (attn + mlp)
        if self.family == "ssm":
            di, st, dr = self.d_inner, self.ssm_state, self.dt_rank_
            per = (D * 2 * di) + (self.d_conv * di) + di * (dr + 2 * st) + dr * di + di * st + di + di * D
            return emb + L * per
        if self.family == "hybrid":
            di, st = self.d_inner, self.ssm_state
            nh = self.mamba_heads
            per = D * 2 * di + self.d_conv * (di + 2 * st * nh) + di * st * 0 + di + di * D + di * (2 * st)
            shared_attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D + 3 * D * F
            return emb + L * per + shared_attn
        if self.family == "encdec":
            enc = self.encoder_layers * (4 * D * D + 2 * D * F)
            dec = L * (4 * D * D + 4 * D * D + 2 * D * F)
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (= param_count for non-MoE)."""

        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim_
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
        mlp_mult = 3 if self.swiglu else 2
        active_mlp = self.experts_per_token * mlp_mult * D * F + D * self.n_experts
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_cells(cfg: ModelConfig) -> list[str]:
    """Shape cells that run for this arch (assignment skip rules)."""

    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""

    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        moe_group_size=16,
        scan_chunk=8,
        n_frames=12 if cfg.family == "encdec" else cfg.n_frames,
        n_patches=4 if cfg.family == "vlm" else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        dt_rank=8 if cfg.family == "ssm" else None,
        mamba_headdim=16 if cfg.family in ("ssm", "hybrid") else cfg.mamba_headdim,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
