#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. build   — compile the four CUDA kernels (``stream_rf``,
   ``flash_attention``, ``ssm_scan``, ``replay``) from
   ``src/repro_torch/kernels/*/csrc``, one nvcc per source, all started
   together;
2. kernels — hold ``stream_stats`` and ``stream_rf`` on the card against
   their plain torch versions and the NumPy oracle, bit for bit (ties of
   differing sizes at every N from 2 to 1024, offsets up to 2^40, int64
   wrap, negative offsets, rows at INT64_MIN and INT64_MAX, the whole
   int64 range, which takes the kernel's wide branch, and packed and wide
   rows in one launch), then at widths that are not powers of two
   (3, 17, 96, 1000: the padded branch) and above 1024 (1025, 2048, 3000,
   4096, 8192: the long-row kernel, the rows of its exact branch counted
   as predicted), ``stream_stats`` with and without per-row true lengths,
   and check that widths above the limit are refused; hold
   ``flash_attention`` and ``ssm_scan`` against their plain
   versions in f32 and bf16 over the reference tests' shapes, GQA/MQA,
   causal or not, Sq != Sk, ragged lengths, every head dim of the
   attention kernel (hd 80 among them) and each served arch's prefill
   shape, at the reference tests' tolerances;
3. golden  — rebuild both golden traces (fingerprints must match), run
   ``FleetProgram`` on the card under both fixture policies within each
   fixture's ``device_tolerance`` (routing fields exact), and replay the
   anomaly shard under its four scheme/gate settings; one ``replay``
   kernel launch a program and a ``simulate_device``;
4. sweep   — the fleet main path at real size: a 1,000,000-request trace
   (64 KiB requests, offsets uniform in [0, 2^38), 16 files, 8 apps, one
   30 s gap mid-trace) over 64 nodes x 4 schemes = 256 lanes,
   range-offset sharding; kernel launch counts are reset just before and
   read just after the first sweep, which must launch ``stream_stats``
   exactly once (every shard's streams in one matrix) and ``replay``
   exactly once (every lane's whole tape in one launch), as must every
   later call; bytes must be conserved, and the card's result must match
   the same sweep run on the CPU (whether bit for bit is printed); the
   first call is timed again in parts, scoring per shard and in one
   launch taking turns; one more steady call is timed after each of the
   profiled run, the first call's parts and the CPU run; then the
   ``replay`` kernel against its plain torch version on the card on the
   sweep's own packed inputs (integer fields exact, clocks within 1e-9
   relative), timed beside it, and one lane of each scheme alone;
   sanitize — the fleet path with every sanitizer check armed
   (``sanitizing()``, ``sanitize=True``): the 16 golden fixtures through
   ``FleetProgram``, bit-equal to the unsanitized card runs above; the
   sweep's steady calls with checks off and on in turns, best of 3 each,
   timed in the sweep before its profiled and CPU runs, and one more
   checked call on the sweep's program (tapes cached), each bit-equal to
   the sweep; the output checks timed alone; a NaN seeded into the
   golden ``mixed-burst`` tape, which must raise ``SanitizerError`` on the
   card when sanitized and reach ``io_seconds`` when not; and
   ``FleetSimulator`` and ``BurstBufferService`` on service load (a) below,
   each bit-equal to its unsanitized twin; ``stream_stats`` launches one a
   program or run, none on the cached sweep (``launches_sanitize``), and
   ``replay`` one a program or replay;
   ftl     — the same sweep with ``ssd="ftl"`` (first call, best of 3
   steady calls, device busy share, the kernel against its plain version,
   GC relocations and write
   amplification): bytes conserved, card equal to the CPU, and within
   ``DEVICE_TOLERANCES`` of ``FleetSimulator(engine="batched",
   ssd="ftl")`` on a trace cut to 50,000 requests (the host engine
   charges the FTL one request at a time);
   host    — ``FleetSimulator(engine="batched")`` over the sweep's 64 nodes
   x 4 schemes (scoring on the card, one launch a run) within
   ``DEVICE_TOLERANCES`` of the sweep; ``run_schemes`` with the device and
   the batched engine on both golden workloads (card equal to the CPU);
   the 16 golden fixtures replayed exactly by the batched engine;
   service — ``BurstBufferService`` on the card, every window scored by
   the stream kernel: (a) the reference's service benchmark (2 GiB of
   four IOR apps, 8,192 requests at 2,000 req/s, 8 nodes) healthy and
   with one crash for each scheme, and a scripted scenario with every
   fault kind (ssdup+, ``ssd="ftl"``: crash with backlog replay, slow
   lane and rebalance, SSD degradation, a stall long enough to rejoin,
   admission redirect); (b) the sweep's trace at 50,000 req/s over 64
   nodes, healthy and with one crash, each scheme.  Gates: byte ledgers
   conserved; one ``stream_stats`` launch a run plus one a resharding
   failover; each run equal to the same run scored by the NumPy oracle;
   (b)'s healthy node results equal to ``FleetSimulator`` above;
   any-len — the sweep at ``stream_len`` 96 and 2048, one launch of each
   kernel each, equal to ``score_backend="numpy"`` (no row of the 2048 sweep takes the
   long-row kernel's exact branch);
   examples — the reference's user entry points as the port runs them:
   each ``examples_torch/*.py`` script's ``main()`` and that of
   ``experiments/anomaly_hunt_torch.py`` in this process, on the card
   (``[examples]`` lines: each script's output and wall).  Gates: the
   stdout of ``quickstart``, ``fleet_sim``, ``service_failover`` and
   ``elastic_recovery`` equal to ``tests/golden_torch/examples/*.txt``
   (held equal to the reference's by a CPU test); one ``stream_stats``
   launch a ``FleetSimulator.run``, a scoring pass and a service run (plus
   one a resharding failover); ``batched_replay`` at 250,000 requests,
   its backends equal and its card scores equal to
   ``score_backend="numpy"``; ``serve_batched``'s attention and scan once
   a layer and its tokens below the padded vocabulary;
   ``train_checkpointed`` at 120 steps resuming at its newest save with
   finite losses; the hunt's CSV byte-identical to
   ``experiments/anomaly_hunt.csv``;
5. timings — both stream kernels held bit-equal to their plain versions on
   every shard matrix the sweep feeds them and on their concatenation,
   and on every shape they are timed at; timed at that one-launch shape
   (as the main path launches it, and with the rows' true lengths), at
   the largest shard's, at the whole trace's and at the sweep's
   one-launch shape at ``stream_len=96``, beside their byte bound, their plain versions and
   ``torch.sort``; and the long-row kernel at the whole trace at
   ``stream_len=2048`` and at ``stream_len=8192``, a row of its own;
6. serve   — the model main path: ``serve`` of qwen3-1.7b, stablelm-3b,
   starcoder2-3b, phi4-mini-3.8b (dense), zamba2-2.7b (hybrid: Mamba-2
   and a shared attention block), falcon-mamba-7b (Mamba-1),
   moonshot-v1-16b-a3b (MoE: top 6 of 64 experts), internvl2-26b (VLM:
   256 seeded patch embeddings over the first positions) and whisper-tiny
   (encoder-decoder: 1,500 seeded frames, a 416-token decoder prompt) at
   full width and depth (zamba2 at 12 of its 54 layers, two groups), and
   grok-1-314b (MoE: top 2 of 8 experts at d_ff 32,768) at full width and
   depth 4, in bf16, batch 4, prompt 2048 (but
   whisper's), 32 greedy tokens, with launch counts reset just before and
   read just after each (attention once a layer, zamba2's once a group of
   six layers, whisper's once an encoder and once a decoder layer; the
   scan once a layer); tokens gated below the padded vocabulary, and
   those in its padding counted; then prefill/decode times from a second
   call, a profile of one prefill and one decode step, ``ssm_scan`` held
   against its plain version on the delta and A falcon-mamba-7b's first
   and last layers give it (x, B and C rescaled to unit RMS; x in bf16 and
   in f32), decode against forward (MoE at ``moe_group_size=1``), and the
   ``"torch"`` prefill against the kernel prefill;
7. f32     — decode against forward and the ``"torch"`` prefill against
   the kernel prefill, at full width in f32, at full depth (zamba2's 54
   layers too) but where it does not fit (moonshot at 12 layers, internvl2
   at 24, grok at 1); and
   card against CPU: each model at full width, depth 2 (zamba2: one group
   of six; whisper: all 4 + 4; grok: 1), one 256-token prompt (internvl2: 512),
   f32 with TF32 off, the same weights on both, with the share of MoE
   routes that differ;
8. levers  — qwen3-1.7b at its published config served unlevered, with
   ``embed_onehot`` (prefill logits and tokens bit-equal to the gather's)
   and with ``matmul_weight_dtype="float8_e4m3fn"`` (hidden states and
   logits bit-equal to the unlevered model on weights rounded through fp8
   beforehand; decode against forward at the bf16 gate), each run's
   prefill and decode times; grok-1-314b with ``param_dtype`` fp8 and
   ``matmul_weight_dtype`` bf16: every leaf fp8, prefill logits at depth 4
   bit-equal to the bf16 model on the same values, then served at 13
   layers (``GROK_FP8_SERVE_DEPTH``; finite logits, tokens below the
   padded vocabulary);
   train   — ``make_train_step`` on the torch paths (the kernels have no
   backward pass) in bf16 with ``remat="block"``, from
   ``ShardedLoader(seed=0)``, AdamW at lr 3e-4, at full width:
   qwen3-1.7b at its published config for 6 steps, falcon-mamba-7b at
   depth 4, moonshot-v1-16b-a3b and internvl2-26b (seeded patch
   embeddings) at depth 2 and whisper-tiny whole (seeded frames, its
   448-token text context) for 3 steps at batch 4 x 2048, and
   zamba2-2.7b at 36 of its 54 layers at 1 x 2048 with gradient
   compression (one row a group of six layers) for 2 steps; each with ``save_async`` mid-run
   and ``save_blocking`` at the end through ``Checkpointer`` ->
   ``TieredCheckpointStore``.  Gates: finite loss and grad_norm every
   step; the restored parameters bit-equal to the live ones; each
   manifest in the reference's layout (every stack under its name); the
   async checkpoint equal to the parameters at its step; the restored
   parameters' kernel prefill bit-equal to the live ones', with one
   kernel launch a layer (a shared-attention group) a prefill, and within
   the serve tolerance of the torch prefill (zamba2: argmax agreement, as
   in serve).  Then falcon-mamba-7b at depth 4 one step with
   ``mamba_fused_proj`` from the weights and batch of its first step
   above (losses within 2e-3; each peak); train steps in f32 on the card and on the CPU from weights
   drawn on the card (``TRAIN_F32_TOL``; whisper whole for 3 steps,
   qwen3-1.7b at depth 2 for 2, moonshot and internvl2 at depth 1 and
   zamba2 at 6 over 32 tokens for 1; MoE routes that differ counted; the CPU
   halves on a worker thread beside the train runs and the fused step);
   and the training CLI, on a second worker thread beside them: the tiny
   preset for 40 steps with a checkpoint every 20, then resumed to 60
   (exit 0, the resume line, the loss falling);
9. mesh    — the sharded model path on a one-rank NCCL process group and
   a (1, 1) ``("data", "model")`` DeviceMesh, each arch at its published
   width (``MESH_RUNS``): qwen3-1.7b at 2 layers, falcon-mamba-7b at 2
   (its prefill's ``ssm_scan`` through ``local_map``), zamba2-2.7b at 6
   at batch 1 (``flash_attention`` at hd 80) and whisper-tiny whole (hd
   64, the encoder non-causal over 1,500 frames): one prefill and 3
   decode steps from the given weights, then one train step, with
   DTensor parameters, AdamW state, batch and cache, each against the
   same steps unsharded (``MESH_TOL``; the decode fed the plain run's
   tokens), the kernels' launches counted and read just after (once a
   layer, a group, or 4 + 4), and qwen3's checkpoint restored through
   ``restore_latest(shardings=)``;
   dryrun  — ``python -m repro_torch.launch.dryrun`` on the card, rank 0
   of the production mesh in a fake world of 512 ranks at full width and
   depth: qwen3-1.7b x {train_4k, prefill_32k, decode_32k} on the
   single-pod mesh, its train_4k on the multi-pod mesh,
   moonshot-v1-16b-a3b's train_4k, falcon-mamba-7b's and zamba2-2.7b's
   decode_32k and long_500k, and whisper-tiny's train_4k (``[dryrun]``
   lines: FLOPs, link bytes, roofline terms, peak, the local step's
   wall), each record's FLOPs and collectives equal to the same cell's
   ``--device cpu`` record (run in subprocesses beside the card's);
10. model-kernel timings — ``flash_attention`` and ``ssm_scan`` at the
   shapes the serve path gives them, beside their bounds, plain versions
   and (attention) ``scaled_dot_product_attention``; attention in bf16
   (tensor cores) and, as ``f32_ms``, in f32 (CUDA cores), at qwen3's
   hd 128, as the row ``flash_attention_hd80`` at stablelm-3b's hd 80
   (the shape of zamba2-2.7b's shared block), and as the row
   ``flash_attention_hd64`` at whisper-tiny's encoder (4, 1500, 6, 64),
   non-causal.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line (``replay`` among them: not a Pallas kernel, the reference's XLA
replay program; no library call computes it), and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import sanitize, sanitizing  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import FleetProgram, TraceBatch, compute_stream_scores  # noqa: E402
from repro_torch.core import FleetResult, FleetSimulator, run_schemes  # noqa: E402
from repro_torch.core import simulate_device  # noqa: E402
from repro_torch.core import engine_device as ed  # noqa: E402
from repro_torch.core.trace import _score_shards_kernel  # noqa: E402
from repro_torch.core.random_factor import stream_stats_batch_np  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.replay import kernel as replay_kernel  # noqa: E402
from repro_torch.kernels.replay import ops as replay_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402
from repro_torch.kernels.stream_rf import kernel, ops, ref  # noqa: E402
from repro_torch.launch.serve import pad_cache, serve  # noqa: E402
from repro_torch.core.workloads import MiB, ior, mixed, relabel  # noqa: E402
from repro_torch.service import BurstBufferService, FaultInjector  # noqa: E402
from repro_torch.service import loop as service_loop  # noqa: E402
from repro_torch.service import poisson_arrivals, scripted  # noqa: E402
from repro_torch.testing.service import ReshardCountingService, same_service_result  # noqa: E402
from repro_torch.models import frontend_inputs, get_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore  # noqa: E402
from repro_torch.data import DataConfig, ShardedLoader  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_params  # noqa: E402
from repro_torch.optim import AdamWConfig, CompressionConfig, init_state  # noqa: E402
from repro_torch.optim import linear_warmup_cosine  # noqa: E402
from repro_torch.distributed.sharding import placements_for  # noqa: E402
from repro_torch.models import stacked_param_axes  # noqa: E402
from repro_torch.testing.sharded import sharded_steps  # noqa: E402
from repro_torch.testing import golden  # noqa: E402
from repro_torch.testing.stream_rows import KINDS, long_row_exact, stream_rows  # noqa: E402
from repro_torch.testing.traces import golden_trace, sweep_trace, trace_fingerprint  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
L2_BYTES = 50 << 20  # H100 L2
SWEEP_REQUESTS = 1_000_000
SWEEP_NODES = 64
SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
KERNEL_SOURCE = "src/repro_torch/kernels/stream_rf/csrc/stream_rf.cu"
REPLACES = {
    "stream_stats": "src/repro/kernels/stream_rf/kernel.py:135",
    "stream_rf": "src/repro/kernels/stream_rf/kernel.py:97",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:95",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:67",
    # no Pallas kernel: the reference's XLA program (lax.scan of vmap(_event_step))
    "replay": "src/repro/core/engine_device.py:1165",
}
REPLAY_SOURCE = "src/repro_torch/kernels/replay/csrc/replay.cu"
# float64 peak of an H100 SXM outside the tensor cores (data sheet), and
# the replay's float64 operations read off replay.cu, split as the kernel
# runs them: the chain's stream event with one region fill (about 80: its
# divisions, log2 and anchor interpolations), its HDD advance (about 115:
# 17 hat terms of 6) and routing; a compute gap; and, ahead of the chain,
# the threshold pass of an SSDUP+ stream event: W additions of its window's
# sum (counted apart) and 4 more (the mean, the index)
FP64_FLOPS = 34e12
REPLAY_OPS_STREAM, REPLAY_OPS_GAP, REPLAY_OPS_THRESHOLD = 200, 12, 4
MODEL_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "ssm_scan": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
}
# H100 SXM published peaks (dense): bf16 tensor cores (the attention
# kernel's bf16 path), and f32 on the CUDA cores (its f32 path takes no
# TF32); special-function units compute 16 exponentials per clock per SM.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16
# the serve slice: batch 4, 2048-token prompts, 32 greedy tokens
SERVE_ARCHS = ("qwen3-1.7b", "stablelm-3b", "starcoder2-3b", "phi4-mini-3.8b", "zamba2-2.7b",
               "falcon-mamba-7b", "moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny",
               "grok-1-314b")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# whisper-tiny's decoder prompt: 416 + 32 generated = 448, Whisper's published
# text context (max_target_positions); its encoder takes 1,500 frames
PROMPT_OF = {"whisper-tiny": 416}
# grok-1-314b at full width: its 64 layers are 628 GB in bf16, one layer 4.9 B
# parameters, so 4 layers (42.5 GB with the embeddings) are served.
# zamba2-2.7b's bf16 serve is cut to 2 of its 9 groups of six layers for the
# script's time limit: its prefill runs the Mamba-2 torch scan (about 14 s at
# batch 4 over 54 layers, six prefills in the phase; at 18 layers the phase
# took 32 s); phase_f32_paths still drives all 54 layers (F32_DEPTH)
SERVE_DEPTH = {"grok-1-314b": 4, "zamba2-2.7b": 12}
# phase_f32_paths in f32 at full width: moonshot's 48 layers need 112 GB,
# internvl2's 48 79.4 GB and grok's 4 85 GB, so their depth is cut; grok's to
# 1, since at 2 (46 GB of weights) the f32 expert transients of one-token
# routing groups (about 35 GB at 4 x 2048) do not fit beside them
F32_DEPTH = {"moonshot-v1-16b-a3b": 12, "internvl2-26b": 24, "grok-1-314b": 1,
             "zamba2-2.7b": 54}
# phase_card_vs_cpu's depth where it is not 2: grok-1-314b's one layer of
# 4.92 B parameters (19.7 GB in f32, held on the card and then the CPU; at
# 2 layers its f32 and card-vs-cpu phases took 31 s)
CARD_VS_CPU_DEPTH = {"grok-1-314b": 1}
SERVE_SEED = 0
BF16_TOL = 0.08  # tests/test_models_smoke.py (2 layers)
# Decode against forward, and the "torch" prefill against the kernel one,
# are gated in bf16 at BF16_TOL where that holds: the dense archs.  After
# falcon-mamba-7b's 64 bf16 layers the gaps are rounding (0.172 and 0.217 at
# logits up to 5.75, while decode against forward in f32 at full depth
# agrees to 4e-5), and after zamba2-2.7b's 54 layers (0.127 and 0.148; 1.9e-5 and
# 1.3e-5 in f32), so there the bf16 values are recorded, argmax agreement
# is gated, and phase_f32_paths holds both comparisons in f32 at full width
# and depth.  moonshot-v1-16b-a3b, internvl2-26b and whisper-tiny stay well
# inside the tolerance (0.0029-0.0117 on an H100); grok-1-314b's four layers
# of 8 x 32,768-wide experts reach 0.044 and 0.039, half of it, so grok's
# are recorded and its argmax agreement gated, as the Mamba archs'.
BF16_GATED = ("qwen3-1.7b", "stablelm-3b", "starcoder2-3b", "phi4-mini-3.8b",
              "moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny")
# zamba2-2.7b's prefill takes about 14 s at batch 4 (the Mamba-2 torch
# scan), so its profile (one prefill, its largest ops, one decode step)
# runs at batch 1; its timed serve and every check run at batch 4.
PROFILE_BATCH = {"zamba2-2.7b": 1}
F32_TOL = {"atol": 1e-3, "rtol": 1e-4}  # card vs CPU, f32, other summation orders
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernel_ssm_scan.py


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# -- inputs -------------------------------------------------------------


def kernel_cases(rng: np.random.Generator):
    """(name, offsets, sizes) matrices: random up to 2^40, heavy ties of
    differing sizes, contiguous and reversed rows; then every row kind of
    ``repro_torch.testing.stream_rows`` at every width the kernel takes:
    ties at every N, int64 wrap, negative offsets, rows at ``INT64_MIN``
    and ``INT64_MAX``, the whole int64 range (the kernel's wide branch) and
    packed and wide rows mixed in one launch."""

    shapes = [(m, n) for m in (1, 3, 8, 37, 300) for n in (8, 64, 128)]
    shapes += [(5, 2), (9, 32), (17, 256), (4, 1024), (7813, 128)]
    for m, n in shapes:
        yield f"random{m}x{n}", rng.integers(0, 1 << 40, size=(m, n)), \
            rng.integers(1, 1 << 20, size=(m, n))
        ties = rng.integers(0, 4, size=(m, n)) * 4096
        yield f"ties{m}x{n}", ties, rng.integers(0, 3, size=(m, n)) * 4096
        run = np.arange(n) * 65536 + rng.integers(0, 1 << 30, size=(m, 1))
        yield f"contig{m}x{n}", run, np.full((m, n), 65536)
        yield f"reversed{m}x{n}", run[:, ::-1].copy(), np.full((m, n), 65536)
    for kind in KINDS:
        for n in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
            for m in (37, 300):
                yield (f"{kind}{m}x{n}", *stream_rows(kind, m, n, rng))
    yield ("mixed7813x128", *stream_rows("mixed", 7813, 128, rng))


# -- timing ---------------------------------------------------------------


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, per_graph: int = 100, replays: int = 20) -> float:
    """Mean device time per launch of ``launch`` (a host call that enqueues
    one kernel on the current stream): ``per_graph`` launches captured in
    one CUDA graph and replayed, so no host time falls between them (a
    ctypes call takes longer than the stream kernel)."""

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            launch()
    return cuda_ms(graph.replay, iters=replays, warmup=2) / per_graph


def bound_ms(m: int, n: int, with_dist: bool) -> float:
    """Least time for the work, bound by bytes: each input read once
    (int64 offset and size per request), each output written once (int64
    rf, plus int64 dist for ``stream_stats``), at the HBM rate.  The
    sort's int64 compare-exchanges are not priced: the card's published
    peaks give no int64 rate."""

    nbytes = m * n * 16 + m * (16 if with_dist else 8)
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phases ---------------------------------------------------------------


def phase_build() -> None:
    """Build every kernel of the port, one nvcc per source, all at once."""

    t0 = time.perf_counter()
    libs = (kernel.LIBRARY, fa_kernel.LIBRARY, ssm_kernel.LIBRARY, replay_kernel.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.load()
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {lib.source.name}: {line.strip()}")


def phase_kernels(dev: torch.device) -> float:
    """Every case bit-equal on the card; returns the largest |error|."""

    rng = np.random.default_rng(12)
    worst = 0
    cases = 0
    wide_total = 0
    kernel.wide_rows(reset=True)
    for name, o_np, s_np in kernel_cases(rng):
        o_np = np.ascontiguousarray(o_np, dtype=np.int64)
        s_np = np.ascontiguousarray(s_np, dtype=np.int64)
        o = torch.from_numpy(o_np).to(dev)
        s = torch.from_numpy(s_np).to(dev)
        rf_k, _, dist_k = ops.stream_stats_op(o, s)
        rf_only = ops.stream_rf_op(o, s)
        rf_p, dist_p = ref.stream_stats_ref(o, s)
        torch.cuda.synchronize()
        rf_np, _, dist_np = stream_stats_batch_np(o_np, s_np)
        for label, got, want in (
            ("stream_stats rf vs plain", rf_k, rf_p),
            ("stream_stats dist vs plain", dist_k, dist_p),
            ("stream_rf vs plain", rf_only, rf_p),
        ):
            err = int((got - want).abs().max()) if got.numel() else 0
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"{name}: {label} differs (max |err| {err})")
        if not (np.array_equal(rf_k.cpu().numpy(), rf_np)
                and np.array_equal(dist_k.cpu().numpy(), dist_np)):
            fail(f"{name}: kernel differs from the NumPy oracle")
        # rows of each launch that took the exact wide branch: every row of
        # a reversed run beside a far offset, none of repairable collisions
        wide = kernel.wide_rows(reset=True) // 2
        wide_total += wide
        m, n = o_np.shape
        if name.startswith("outlier") and n >= 16 and wide != m:
            fail(f"{name}: {wide} of {m} rows took the wide branch, expected all")
        if name.startswith("collide") and wide:
            fail(f"{name}: {wide} rows took the wide branch, expected none")
        cases += 1
    log(f"[kernels] {cases} cases bit-equal to the plain version and the "
        f"NumPy oracle; {wide_total} rows scored by the kernel's wide branch")
    return float(worst)


ANY_WIDTHS = (3, 17, 96, 1000)  # not powers of two: the padded branch
LONG_WIDTHS = (1025, 2048, 3000, 4096, 8192)  # the long-row kernel, one block a row


def _oracle_rows(offs: np.ndarray, szs: np.ndarray, lens) -> tuple[np.ndarray, np.ndarray]:
    """The NumPy oracle on each row's first ``lens[i]`` requests."""

    if lens is None:
        rf, _, dist = stream_stats_batch_np(offs, szs)
        return rf, dist
    got = [stream_stats_batch_np(offs[i:i + 1, :k], szs[i:i + 1, :k])
           for i, k in enumerate(lens)]
    return (np.array([g[0][0] for g in got], dtype=np.int64),
            np.array([g[2][0] for g in got], dtype=np.int64))


def phase_any_width(dev: torch.device) -> float:
    """Widths that are not powers of two and widths above 1024, on every
    row kind: both kernels bit-equal to the plain version and to the NumPy
    oracle, ``stream_stats`` also with per-row true lengths; the long-row
    kernel scores exactly the rows above 1024, by its exact branch exactly
    the rows ``long_row_exact`` predicts; widths above the limit raise.
    Returns the largest |error|."""

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    worst, cases, long_total, exact_total = 0, 0, 0, 0
    for kind in KINDS:
        for n in ANY_WIDTHS + LONG_WIDTHS:
            for m in ((37, 300) if n <= 1024 else (5, 37)):
                offs, szs = stream_rows(kind, m, n, rng)
                lens = rng.integers(0, n + 1, size=m)
                lens[:3] = (0, 1, n)
                o, s = torch.from_numpy(offs).to(dev), torch.from_numpy(szs).to(dev)
                for ln_np in (None, lens):
                    ln = None if ln_np is None else torch.from_numpy(ln_np).to(dev)
                    kernel.long_rows(reset=True)
                    kernel.long_wide_rows(reset=True)
                    rf_k, _, dist_k = ops.stream_stats_op(o, s, ln)
                    rf_p, dist_p = ref.stream_stats_ref(o, s, ln)
                    checks = [("rf", rf_k, rf_p), ("dist", dist_k, dist_p)]
                    if ln is None:  # stream_rf_op takes no lengths
                        checks.append(("stream_rf", ops.stream_rf_op(o, s), rf_p))
                    torch.cuda.synchronize()
                    for label, got, want in checks:
                        worst = max(worst, int((got - want).abs().max()))
                        if not torch.equal(got, want):
                            fail(f"{kind} ({m}, {n}) lengths={ln_np is not None}: "
                                 f"{label} differs from the plain version")
                    rf_np, dist_np = _oracle_rows(offs, szs, ln_np)
                    if not (np.array_equal(rf_k.cpu().numpy(), rf_np)
                            and np.array_equal(dist_k.cpu().numpy(), dist_np)):
                        fail(f"{kind} ({m}, {n}): kernel differs from the NumPy oracle")
                    long = kernel.long_rows(reset=True)
                    if long != ((1 + (ln is None)) * m if n > 1024 else 0):
                        fail(f"{kind} ({m}, {n}): {long} rows in the long-row kernel")
                    long_total += long
                    exact = kernel.long_wide_rows(reset=True)
                    want = int(long_row_exact(offs, ln_np).sum()) if n > 1024 else 0
                    if exact != (1 + (ln is None)) * want:
                        fail(f"{kind} ({m}, {n}) lengths={ln_np is not None}: {exact} rows "
                             f"in the long-row kernel's exact branch, expected "
                             f"{(1 + (ln is None)) * want}")
                    exact_total += exact
                    cases += 1
    for n in (ops.MAX_STREAM_LEN + 1, 2 * ops.MAX_STREAM_LEN):
        z = torch.zeros(2, n, dtype=torch.int64, device=dev)
        try:
            ops.stream_stats_op(z, z)
        except ValueError:
            continue
        fail(f"width {n} above the kernel's limit was not refused")
    log(f"[kernels] any width: {cases} cases at N in {ANY_WIDTHS + LONG_WIDTHS} "
        f"(stream_stats with and without true lengths) bit-equal to the plain version and "
        f"the NumPy oracle; {long_total} rows through the long-row kernel, {exact_total} "
        f"of them by its exact branch; "
        f"N > {ops.MAX_STREAM_LEN} refused ({time.perf_counter() - t0:.1f} s)")
    return float(worst)


def device_ops(prof) -> list:
    """[name, device ms, calls] of each op with device time in a profile,
    the most device time first."""

    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append([e.key[:80], t / 1e3, e.count])
    return sorted(rows, key=lambda r: -r[1])


def device_time(fn, iters: int = 1) -> tuple[float, float, int]:
    """Profile ``iters`` calls of ``fn``: ``(wall s, device busy s, device
    ops)``, the device numbers summed over the profiler's trace."""

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_ops(prof)
    return wall, sum(r[1] for r in rows) / 1e3, sum(r[2] for r in rows)


def profiled(fn, iters: int = 50) -> tuple[float, int]:
    """Device ms per call of the torch ops ``fn`` runs, and device ops
    per call.  (The profiler does not see the kernel itself: its library
    links the CUDA runtime statically, outside the profiler's hooks.)"""

    fn()
    torch.cuda.synchronize()
    _, busy, count = device_time(fn, iters)
    return busy * 1e3 / iters, count // iters


def raw_launch(o: torch.Tensor, s: torch.Tensor, with_dist: bool, copies: int = 1,
               lens: torch.Tensor | None = None):
    """The kernel's C entry point with no wrapper around it, on the current
    stream (``lens``: the rows' true lengths, as the main path passes
    them).  With ``copies`` > 1 the launches take turns over that many
    copies of the inputs, so that a launch finds its inputs evicted from
    L2 when the copies exceed it."""

    lib = kernel.load()
    m, n = o.shape
    rf = torch.empty(m, dtype=torch.int64, device=o.device)
    dist = torch.empty(m, dtype=torch.int64, device=o.device)
    bufs = [(o, s)] + [(o.clone(), s.clone()) for _ in range(copies - 1)]
    args = [(a.data_ptr(), b.data_ptr(), None if lens is None else lens.data_ptr(),
             rf.data_ptr(), dist.data_ptr() if with_dist else None, m, n)
            for a, b in bufs]
    turn = iter(range(1 << 62))

    def launch():
        if lib.stream_stats_launch(*args[next(turn) % copies],
                                   torch.cuda.current_stream().cuda_stream) != 0:
            fail("raw stream_stats launch failed")

    launch.buffers = (bufs, rf, dist, lens)  # alive while the pointers are used
    return launch


def one_launch_matrix(shards: list[TraceBatch], stream_len: int = 128
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The matrix the sweep's scoring launches once: every shard's padded
    stream matrix, concatenated (``core.trace._score_shards_kernel``), and
    each row's true length (which the launch takes only where a pad cannot
    be score-neutral, never on the sweep's trace)."""

    mats = [b.padded_stream_matrix(stream_len) for b in shards]
    return tuple(np.concatenate([m[i] for m in mats]) for i in range(3))


def check_shards(dev: torch.device, shards: list[TraceBatch]) -> int:
    """Both kernels bit-equal to their plain versions on every padded
    shard matrix of the sweep and on their concatenation, the matrix the
    main path launches (``stream_stats`` on every other one with the rows'
    true lengths); returns the largest |error|."""

    worst = 0
    mats = [b.padded_stream_matrix() for b in shards]
    for i, (o_np, s_np, l_np) in enumerate(mats + [one_launch_matrix(shards)]):
        o = torch.from_numpy(o_np).to(dev)
        s = torch.from_numpy(s_np).to(dev)
        ln = torch.from_numpy(l_np).to(dev) if i % 2 else None
        rf_p, dist_p = ref.stream_stats_ref(o, s, ln)
        rf_k, _, dist_k = ops.stream_stats_op(o, s, ln)
        for label, got, want in (
            ("stream_stats rf", rf_k, rf_p),
            ("stream_stats dist", dist_k, dist_p),
            ("stream_rf", ops.stream_rf_op(o, s), ref.stream_rf_ref(o, s)),
        ):
            if got.numel():
                worst = max(worst, int((got - want).abs().max()))
            if not torch.equal(got, want):
                what = f"shard {i}" if i < len(shards) else "one-launch matrix"
                fail(f"sweep {what} {tuple(o.shape)}: {label} differs "
                     "from the plain version")
    log(f"[kernels] {len(shards)} sweep shard matrices (stream_stats on every other "
        f"one with its true lengths) and their concatenation {tuple(o.shape)} bit-equal to the "
        "plain version")
    return worst


def held_to_plain(o, s, ln, with_dist: bool, label: str) -> int:
    """The wrapper bit-equal to its plain version on one timed shape;
    returns the largest |error|."""

    if with_dist:
        rf_k, _, dist_k = ops.stream_stats_op(o, s, ln)
        rf_p, dist_p = ref.stream_stats_ref(o, s, ln)
        pairs = ((rf_k, rf_p), (dist_k, dist_p))
    else:
        pairs = ((ops.stream_rf_op(o, s), ref.stream_rf_ref(o, s)),)
    for got, want in pairs:
        if not torch.equal(got, want):
            fail(f"{label} {tuple(o.shape)} differs from the plain version")
    return max(int((got - want).abs().max()) for got, want in pairs)


def _timed_shape(o, s, ln, with_dist: bool, key: str) -> dict:
    """One shape's times (see :func:`kernel_timings`), ``key`` suffixed."""

    op = ops.stream_stats_op if with_dist else ops.stream_rf_op
    plain = ref.stream_stats_ref if with_dist else ref.stream_rf_ref
    m, n = o.shape
    copies = -(-2 * L2_BYTES // (m * n * 16))
    args = (o, s, ln) if with_dist else (o, s)
    plain_ms, plain_ops = profiled(lambda: plain(*args))
    lib_ms, _ = profiled(lambda: torch.sort(o, dim=1, stable=True))
    return {
        f"ms{key}": graph_ms(raw_launch(o, s, with_dist, lens=ln)),
        # inputs rotated over copies that fill twice the L2
        f"ms_cold{key}": graph_ms(raw_launch(o, s, with_dist, copies=copies, lens=ln),
                                  per_graph=max(100, copies)),
        f"plain_ms{key}": plain_ms,
        f"bound_ms{key}": bound_ms(m, n, with_dist),
        f"bound_by{key}": "bytes",
        f"library_ms{key}": lib_ms,
        f"call_ms{key}": cuda_ms(lambda: op(*args)),
        f"plain_device_ops{key}": plain_ops,
        f"shape{key}": [m, n],
    }


def kernel_timings(dev: torch.device, batch: TraceBatch, worst: float,
                   launches: dict, any_len: dict) -> list[dict]:
    """Times at the main path's shape, the concatenation of the sweep's
    padded shard matrices (one launch for all shards); beside it the same
    with the rows' true lengths (``_with_lengths``, ``stream_stats`` only:
    the kernel's instance for them, which a launch takes only where a pad
    cannot be score-neutral), the largest shard's matrix (the shape of one launch
    per shard), the whole trace as one matrix, and (``_len96``) the
    one-launch matrix of the sweep at ``stream_len=96`` (the padded
    branch: a 128-wide sort of 96 requests);
    and, as a row of its own, the long-row kernel on the whole trace at
    ``stream_len=2048`` (489, 2048) and (``_8192``) at ``stream_len=8192``
    (123, 8192).  ``ms``: raw launches back to back in
    a CUDA graph on the same inputs (in L2 after the first); ``ms_cold``:
    the same with the inputs rotated over copies that fill twice the L2;
    ``plain_ms``/``library_ms``: device time from the profiler;
    ``call_ms``: CUDA events per wrapper call, host overhead included.
    ``any_len`` holds the launch counts of the ``stream_len`` 96 and 2048
    sweeps.  Each shape is first held bit-equal to the plain version."""

    prog = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES,
                        policy="range-offset", device=dev)
    shards = prog.shard(batch)
    worst = float(max(worst, check_shards(dev, shards)))
    shard = max(shards, key=lambda b: b.num_requests)
    rows = {}
    for key, mats in (("", one_launch_matrix(shards)),
                      ("_largest_shard", shard.padded_stream_matrix()),
                      ("_whole_trace", batch.padded_stream_matrix()),
                      ("_len96", one_launch_matrix(shards, 96))):
        # as the main path launches them: score-neutral pads, no lengths
        rows[key] = tuple(torch.from_numpy(a).to(dev) for a in mats[:2]) + (None,)
    rows["_with_lengths"] = rows[""][:2] + (
        torch.from_numpy(one_launch_matrix(shards)[2]).to(dev),)
    out = []
    for name, with_dist in (("stream_stats", True), ("stream_rf", False)):
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": worst}
        for key, (o, s, ln) in rows.items():
            if ln is not None and not with_dist:
                continue  # stream_rf_op takes no lengths
            err = held_to_plain(o, s, ln, with_dist, name + key)
            entry["max_abs_err"] = float(max(entry["max_abs_err"], err))
            entry.update(_timed_shape(o, s, ln, with_dist, key))
        entry["launches_len96"] = any_len[96]["launches"][name]
        entry["library_call"] = ("torch.sort(offsets, dim=1, stable=True): the "
                                 "sort alone, a yardstick the port never calls")
        out.append(entry)
    o, s = (torch.from_numpy(a).to(dev) for a in batch.padded_stream_matrix(2048)[:2])
    ln = None  # as the stream_len=2048 sweep launches it
    long_entry = {"name": "stream_stats_long_rows", "route": "cuda", "source": KERNEL_SOURCE,
                  "replaces": REPLACES["stream_stats"],
                  "launches": any_len[2048]["launches"]["stream_stats"],
                  "max_abs_err": float(max(worst, held_to_plain(o, s, ln, True,
                                                                "long-row kernel"))),
                  "main_path": "the sweep at stream_len=2048 (one launch of its 64 shards' "
                               "512 rows; timed on the whole trace's 489)"}
    long_entry.update(_timed_shape(o, s, ln, True, ""))
    long_entry["long_rows_sweep"] = any_len[2048]["long_rows"]
    long_entry["long_wide_rows_sweep"] = any_len[2048]["long_wide_rows"]
    o, s = (torch.from_numpy(a).to(dev) for a in batch.padded_stream_matrix(8192)[:2])
    long_entry["max_abs_err"] = float(max(long_entry["max_abs_err"],
                                          held_to_plain(o, s, None, True, "long-row kernel")))
    long_entry.update(_timed_shape(o, s, None, True, "_8192"))
    long_entry["library_call"] = out[0]["library_call"]
    out.append(long_entry)
    return out


def golden_program(dev: torch.device, batch: TraceBatch, policy: str) -> FleetProgram:
    """The fixture matrix's four schemes under ``policy`` in one program."""

    return FleetProgram(num_nodes=golden.FIXTURE_NODES, schemes=golden.FIXTURE_SCHEMES,
                        policy=policy, ssd_capacity=golden._node_capacity(batch.total_bytes),
                        device=dev)


def replay_row(launches: dict, held: dict, ftl: dict, golden_replays: int,
               sanitized: dict, host: dict, any_len: dict) -> dict:
    """The kernels line's ``replay`` entry: the sweep's (constant SSD) and
    the FTL sweep's numbers from :func:`replay_held`, and the launches of
    each phase (one a ``FleetProgram.run``, gated where they ran)."""

    fh = ftl["held"]
    return {"name": "replay", "route": "cuda", "source": REPLAY_SOURCE,
            "replaces": REPLACES["replay"], "launches": launches["replay"],
            "max_abs_err": max(held["max_abs_err"], fh["max_abs_err"]),
            "ms": held["ms"], "plain_ms": held["plain_ms"], "bound_ms": held["bound_ms"],
            "bound_by": held["bound_by"], "library_ms": None,
            "ops_bound_ms": held["ops_bound_ms"], "max_rel_err": held["max_rel_err"],
            "one_lane_ms": held["one_lane_ms"], "bit_equal_cpu": held["bit_equal_cpu"],
            "max_rel_gap_cpu": held["max_rel_gap_cpu"], "shape": [held["steps"], held["lanes"]],
            "ftl_ms": fh["ms"], "ftl_plain_ms": fh["plain_ms"], "ftl_bound_ms": fh["bound_ms"],
            "ftl_one_lane_ms": fh["one_lane_ms"], "ftl_bit_equal_cpu": fh["bit_equal_cpu"],
            "ftl_max_abs_err": fh["max_abs_err"], "launches_ftl_sweep": ftl["launches"]["replay"],
            "launches_golden": golden_replays, "launches_sanitize": sanitized["replay_launches"],
            "launches_host_engines": host["launches"]["replay"],
            "launches_any_len": {n: r["launches"]["replay"] for n, r in any_len.items()},
            "library_call": "none: no PyTorch call computes the replay",
            "main_path": "FleetProgram.run of the 1M-request sweep, 64 nodes x 4 schemes "
                         "(one launch a run); not a Pallas kernel: the reference's XLA program"}


def phase_golden(dev: torch.device) -> tuple[dict, int]:
    """The 16 fixtures on the card, one ``replay`` launch a program and one
    a ``simulate_device``; returns (workload, policy) -> the program's
    results, and the replay launches."""

    runs = {}
    replay_ops.reset_launches()
    for wl in golden.FIXTURE_WORKLOADS:
        batch = golden_trace(wl)
        for policy in golden.FIXTURE_POLICIES:
            res = runs[wl, policy] = golden_program(dev, batch, policy).run(batch)
            if replay_ops.launches["replay"] != len(runs):
                fail(f"golden {wl} {policy}: replay launched "
                     f"{replay_ops.launches['replay'] - len(runs) + 1} times, expected 1")
            for scheme, fr in res.items():
                path = golden.GOLDEN_DIR / golden.fixture_name(scheme, wl, policy)
                payload = golden.load_fixture(path)
                if payload["trace"] != trace_fingerprint(batch):
                    fail(f"golden trace {wl} drifted from {path.name}")
                diffs = golden.check_fixture(
                    payload, fr, tolerances=payload["device_tolerance"])
                if scheme != "orangefs-bb":
                    diffs += golden.diff_routing(
                        payload["result"], golden.fleet_result_to_dict(fr))
                if diffs:
                    fail(f"{path.name} on the card:\n" + "\n".join(diffs))
    log("[golden] 16 fixtures within device_tolerance on the card, routing exact")
    payload, shard = golden.load_anomaly_fixture()
    io = {}
    for key, scheme, gate in golden.ANOMALY_RUNS:
        r = simulate_device(shard, scheme=scheme,
                            ssd_capacity=payload["ssd_capacity"],
                            flush_gate=gate, device=dev)
        diffs = golden.diff_sim(payload["expected"][key]["result"],
                                golden.sim_result_to_dict(r),
                                tolerances=payload["device_tolerance"])
        if diffs:
            fail(f"anomaly {key} on the card:\n" + "\n".join(diffs))
        io[key] = r.io_seconds
    # the shortfall (ssdup+ at gate 0.5 loses to orangefs) and its fix
    if not (io["ssdup+_gate0.5"] > 1.5 * io["orangefs"]
            and io["ssdup+_gate0.75"] < io["orangefs"]):
        fail(f"anomaly ordering lost: {io}")
    log(f"[golden] anomaly: 4 keys met, io_seconds {json.dumps(io)}")
    want = len(runs) + len(golden.ANOMALY_RUNS)
    if replay_ops.launches["replay"] != want:
        fail(f"[golden] replay launched {replay_ops.launches['replay']} times, expected {want} "
             "(one a FleetProgram run, one a simulate_device)")
    return runs, replay_ops.launches["replay"]


def first_call_parts(dev: torch.device, prog: FleetProgram, batch: TraceBatch,
                     t_first: float) -> dict:
    """The sweep's first call in parts, each timed again on its own (host
    clock, ending in a synchronise): sharding, scoring, tape building.
    Scoring runs both ways in turns (per shard, one launch, one launch,
    per shard): one ``compute_stream_scores`` per shard, as before, and
    ``_score_shards_kernel`` over all shards, as the main path does."""

    def clock(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    shards = prog.shard(batch)
    t_shard = clock(lambda: prog.shard(batch))
    ways = {
        "per_shard": lambda: [compute_stream_scores(b, prog.stream_len, device=dev)
                              for b in shards],
        "one_launch": lambda: _score_shards_kernel(shards, prog.stream_len, dev),
    }
    times = {k: [] for k in ways}
    for k in ("per_shard", "one_launch", "one_launch", "per_shard"):
        times[k].append(clock(ways[k]))
    scores = _score_shards_kernel(shards, prog.stream_len, dev)
    t_tapes = clock(lambda: [ed.build_events(b, sc, stream_len=prog.stream_len,
                                             hdd=prog.hdd, ssd=prog.ssd, link=prog.link)
                             for b, sc in zip(shards, scores)])
    out = {"first_call_s": t_first, "shard_s": t_shard, "tapes_s": t_tapes,
           **{f"score_{k}_s": v for k, v in times.items()},
           **{f"score_{k}_share": min(v) / t_first for k, v in times.items()}}
    log(f"[sweep] first call in parts (s): shard {t_shard:.4f}, tapes {t_tapes:.4f}; "
        f"scoring per shard {json.dumps(times['per_shard'])} "
        f"({out['score_per_shard_share']:.3%} of the first call), one launch "
        f"{json.dumps(times['one_launch'])} ({out['score_one_launch_share']:.3%})")
    log(f"[sweep] first call parts {json.dumps(out)}")
    return out


def sweep_capacity(batch: TraceBatch) -> int:
    return max(batch.total_bytes // 2 // SWEEP_NODES, 64 << 20)


INT_FIELDS = ("bytes_to_ssd", "bytes_to_hdd_direct", "flushes", "peak_ssd_occupancy")
CLOCK_FIELDS = ("io_seconds", "total_seconds", "blocked_seconds", "flush_paused_seconds")


def same_within(label: str, got: dict, want: dict, rel: float = 1e-9) -> float:
    """``got`` and ``want`` (scheme -> FleetResult): integer fields exact,
    clocks within ``rel``; returns the largest relative clock gap."""

    worst = 0.0
    for s in want:
        for i, (a, b) in enumerate(zip(got[s].node_results, want[s].node_results)):
            for f in INT_FIELDS:
                if getattr(a, f) != getattr(b, f):
                    fail(f"{label} {s}[{i}].{f}: {getattr(a, f)} != {getattr(b, f)}")
            for f in CLOCK_FIELDS:
                x, y = getattr(a, f), getattr(b, f)
                gap = abs(x - y) / max(abs(y), 1e-300)
                worst = max(worst, gap)
                if gap > rel:
                    fail(f"{label} {s}[{i}].{f}: {x!r} vs {y!r}")
    return worst


def conserved(label: str, res: dict, total: int) -> None:
    """Every scheme routed all ``total`` bytes, with finite clocks >= 0."""

    for s, fr in res.items():
        if fr.total_bytes != total:
            fail(f"{label} {s}: routed {fr.total_bytes} bytes of {total}")
        vals = [v for r in fr.node_results
                for v in (r.io_seconds, r.total_seconds, r.blocked_seconds)]
        if not all(math.isfinite(v) and v >= 0 for v in vals):
            fail(f"{label} {s}: non-finite or negative clocks")


def host_probe(dev: torch.device) -> dict:
    """The host's speed and the cost of a launch, to tell them apart: a
    fixed pure-Python loop (s) and 20,000 launches of a one-element add
    (µs a launch, host clock, ending in a synchronise)."""

    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    python_s = time.perf_counter() - t0
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20_000):
        x.add_(1)
    torch.cuda.synchronize()
    return {"python_s": python_s, "launch_us": (time.perf_counter() - t0) / 20_000 * 1e6}


def phase_sweep(dev: torch.device, batch: TraceBatch, ssd: str = "constant"
                ) -> tuple[dict, int, dict, float, FleetProgram, dict, dict]:
    """The fleet main path at real size with storage model ``ssd``: one
    ``stream_stats`` launch and one ``replay`` launch a call (every call
    checked), first call, best of 3 steady calls, device busy share; bytes
    conserved and the card equal to the CPU (integer fields exact, clocks
    within 1e-9 relative; whether bit for bit is printed); then the replay
    kernel against its plain version on the card (:func:`replay_held`).  With the constant SSD the
    steady calls take turns with 3 calls under ``sanitizing()`` (off, on,
    on, off, off, on), each bit-equal to the first call, before anything
    else runs; then one more unchecked call is timed after each later step
    (the profiled run, the first call's parts, the CPU run), to show which
    of them slows the calls after it, and :func:`host_probe` runs before
    the steady calls, after them and after the profiled and CPU runs.  Returns the launch counts, the
    wide-branch rows, the result, the best steady time, the program and
    the steady times (``"off"``, ``"on"``, ``"after"``, and ``"cpu_share"``:
    the main thread's CPU time over the wall time of each timed call) and
    :func:`replay_held`'s numbers."""

    tag = "[sweep]" if ssd == "constant" else f"[{ssd}]"
    t_phase = time.perf_counter()
    cap = sweep_capacity(batch)
    lanes = SWEEP_NODES * len(SCHEMES)
    kw = dict(num_nodes=SWEEP_NODES, schemes=SCHEMES, policy="range-offset",
              ssd_capacity=cap, ssd=ssd)
    prog = FleetProgram(device=dev, **kw)
    kernel.wide_rows(reset=True)
    ops.reset_launches()
    replay_ops.reset_launches()
    t0 = time.perf_counter()
    res = prog.run(batch)  # scores every shard on the card, builds tapes
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.launches, **replay_ops.launches)
    wide = kernel.wide_rows(reset=True)
    if launches["stream_stats"] != 1:
        fail(f"{tag} stream_stats launched {launches['stream_stats']} times on the "
             "main path, expected exactly 1 (all shards in one launch)")
    one_replay(tag, "the first call", launches["replay"])
    probe = ssd == "constant"
    first = res

    def one_call() -> float:
        nonlocal res
        replay_ops.reset_launches()
        torch.cuda.synchronize()
        t0, cpu0 = time.perf_counter(), time.thread_time()
        res = prog.run(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times["cpu_share"].append((time.thread_time() - cpu0) / wall)
        one_replay(tag, "a steady call", replay_ops.launches["replay"])
        return wall

    # cpu_share: the main thread's CPU time over the wall time of each call
    times = {"off": [], "on": [], "after": {}, "cpu_share": []}
    probes = {"before_steady": host_probe(dev)} if probe else {}
    for on in (False, True, True, False, False, True) if probe else (False,) * 3:
        with sanitizing(on):
            times["on" if on else "off"].append(one_call())
        if probe:
            same_fleet(f"(b) sweep (checks {'on' if on else 'off'})", res, first)
    steady = times["off"]
    t_best = min(steady)
    if probe:
        probes["after_steady"] = host_probe(dev)
    replay_ops.reset_launches()
    t_prof, busy, n_ops = device_time(lambda: prog.run(batch))
    one_replay(tag, "the profiled call", replay_ops.launches["replay"])
    if probe:
        probes["after_profiled_run"] = host_probe(dev)
        times["after"]["profiled_run"] = one_call()
    conserved(tag, res, batch.total_bytes)
    totals = {s: fr.total_bytes for s, fr in res.items()}
    log(f"{tag} ssd={ssd!r}, {batch.num_requests:,} requests, {SWEEP_NODES} nodes x "
        f"{len(SCHEMES)} schemes = {lanes} lanes, ssd_capacity {cap}")
    log(f"{tag} first call {t_first:.3f} s (scoring + tapes + replay), "
        f"steady {json.dumps(steady)} s, best {t_best:.3f} s = "
        f"{lanes / t_best:.1f} lanes/s")
    log(f"{tag} profiled steady run {t_prof:.3f} s: device busy "
        f"{busy:.4f} s ({busy / t_prof:.2%}), {n_ops} device ops")
    log(f"{tag} launches on the main path: {json.dumps(launches)}; rows scored "
        f"by the stream kernel's wide branch: {wide}")
    log(f"{tag} total bytes per scheme: {json.dumps(totals)}")

    if probe:
        first_call_parts(dev, prog, batch, t_first)
        times["after"]["first_call_parts"] = one_call()

    t0 = time.perf_counter()
    cpu_res = FleetProgram(device="cpu", **kw).run(batch)
    worst = same_within(f"{tag} card vs cpu", res, cpu_res)
    bitwise = all(golden.fleet_result_to_dict(res[s]) == golden.fleet_result_to_dict(cpu_res[s])
                  for s in SCHEMES)
    log(f"{tag} card == cpu: integer fields exact, clocks max rel diff "
        f"{worst!r}, bit for bit: {bitwise} (cpu run {time.perf_counter() - t0:.1f} s)")
    if probe:
        probes["after_cpu_run"] = host_probe(dev)
        log(f"{tag} host probe (a pure-Python loop s, a one-element add's launch us): "
            f"{json.dumps(probes)}")
        times["after"]["cpu_run"] = one_call()
        log(f"{tag} one steady call after each later step (s): {json.dumps(times['after'])} "
            f"(best steady before them {t_best:.4f} s); the main thread's cpu time over "
            f"the wall time of each timed steady call, in order: {json.dumps(times['cpu_share'])}")
    held = replay_held(dev, prog, batch, tag)
    held.update(bit_equal_cpu=bitwise, max_rel_gap_cpu=worst)
    log(f"{tag} profiled steady run with the replay kernel's own time (CUDA events; the "
        f"profiler does not see it): busy {busy + held['ms'] / 1e3:.4f} s of {t_prof:.3f} s "
        f"({(busy + held['ms'] / 1e3) / t_prof:.2%}), {n_ops} + 1 device ops")
    log(f"{tag} sweep and card-vs-cpu {time.perf_counter() - t_phase:.1f} s")
    return launches, wide, res, t_best, prog, times, held


def one_replay(tag: str, what: str, n: int) -> None:
    if n != 1:
        fail(f"{tag} {what} launched the replay kernel {n} times, expected exactly 1 "
             "(every lane in one launch)")


def raw_replay(p: replay_ops.Packed, g: list, steps: int):
    """The replay kernel's launch with no wrapper around it (no status read
    back, not counted), on the current stream, over packed inputs ``p``."""

    launch = replay_ops.launcher(p, g, steps)

    def run():
        try:
            launch()
        except RuntimeError as err:
            fail(f"raw replay launch: {err}")

    return run


def replay_bound_ms(p: replay_ops.Packed, steps: int) -> tuple[float, float]:
    """The least time of one replay: (bytes, operations).  Bytes: the
    packed inputs read once and the ten outputs written once, at the HBM
    rate.  Operations: this tape's stream and gap events (the first
    ``steps`` of each lane) at ``REPLAY_OPS_STREAM`` and ``REPLAY_OPS_GAP``
    float64 operations each, and each SSDUP+ stream event's window sum
    (``W`` additions, ``REPLAY_OPS_THRESHOLD`` more), at ``FP64_FLOPS``."""

    parts = [getattr(p, f.name) for f in dataclasses.fields(p)]
    lanes, w = p.win.shape
    nbytes = sum(t.numel() * t.element_size() for t in parts) + lanes * 10 * 8
    valid, gap = (p.tape_u8[i, :, :steps].bool() for i in range(2))
    stream = valid & ~gap
    plus = p.lane_i64[replay_ops.LANE_I64.index("scheme")] == ed.SCHEME_IDS["ssdup+"]
    streams, gaps = int(stream.sum()), int((valid & gap).sum())
    plus_streams = int(stream[plus].sum())
    ops_s = (streams * REPLAY_OPS_STREAM + gaps * REPLAY_OPS_GAP
             + plus_streams * (w + REPLAY_OPS_THRESHOLD)) / FP64_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def replay_held(dev: torch.device, prog: FleetProgram, batch: TraceBatch, tag: str) -> dict:
    """The replay kernel against the plain torch transition
    (``replay_ops.plain``, i.e. ``kernels/replay/ref.py``) on the card, on
    the sweep's own packed inputs: integer fields exact, clocks within
    1e-9 relative.  Times: the kernel by raw launches back to back (CUDA
    events, the inputs warm in L2), the plain version once (CUDA events),
    and one lane of each scheme alone (node 0's), to show what the longest
    lane's chain costs; beside the bound (:func:`replay_bound_ms`)."""

    events, lanes, state0, _ = prog._lane_inputs(batch)
    p, g, steps = ed.replay_inputs(events, lanes, state0, hdd=prog.hdd,
                                   interference=prog.interference, device=dev)
    got = replay_ops.replay_op(p, g, steps)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    want = replay_ops.plain(p, g, steps)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    worst_abs = worst_rel = 0.0
    for k, v in got.items():
        if v.dtype.is_floating_point:
            gap = (v - want[k]).abs()
            worst_abs = max(worst_abs, float(gap.max()))
            worst_rel = max(worst_rel, float((gap / want[k].abs().clamp_min(1e-300)).max()))
        elif not torch.equal(v, want[k]):
            fail(f"{tag} replay kernel {k} differs from the plain version on the card")
    if worst_rel > 1e-9:
        fail(f"{tag} replay kernel clocks {worst_rel!r} relative from the plain version")
    ms = cuda_ms(raw_replay(p, g, steps), iters=50, warmup=3)
    one_lane = {}
    for si, scheme in enumerate(prog.schemes):
        i = [si * prog.num_nodes]
        p1, g1, s1 = ed.replay_inputs({k: v[:, i] for k, v in events.items()},
                                      {k: v[i] for k, v in lanes.items()},
                                      {k: v[i] for k, v in state0.items()},
                                      hdd=prog.hdd, interference=prog.interference, device=dev)
        one_lane[scheme] = cuda_ms(raw_replay(p1, g1, s1), iters=50, warmup=3)
    bytes_ms, ops_ms = replay_bound_ms(p, steps)
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "ops_bound_ms": ops_ms, "one_lane_ms": one_lane, "max_abs_err": worst_abs,
           "max_rel_err": worst_rel, "steps": steps, "lanes": p.win.shape[0]}
    log(f"{tag} replay kernel vs its plain version on the card ({out['lanes']} lanes, "
        f"{steps} events): integer fields exact, clocks max |diff| {worst_abs!r} (rel "
        f"{worst_rel!r}); kernel {ms:.4f} ms (raw launches), plain {plain_ms:.1f} ms, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}; operations {ops_ms * 1e3:.3f} us); "
        f"one lane alone (ms) {json.dumps(one_lane)}")
    return out


FTL_HOST_REQUESTS = 50_000  # the host FTL comparison's cut (see phase_ftl_sweep)


def within_device_tolerances(label: str, host: dict, device: dict) -> None:
    """Each scheme's device-engine fleet within ``DEVICE_TOLERANCES`` of the
    host batched engine's (the reference's acceptance comparison)."""

    tol = {k: list(v) for k, v in ed.DEVICE_TOLERANCES.items()}
    for s in host:
        diffs = golden.diff_fleet(golden.fleet_result_to_dict(host[s]),
                                  golden.fleet_result_to_dict(device[s]), tolerances=tol)
        if diffs:
            fail(f"{label} {s}: device engine outside DEVICE_TOLERANCES of the "
                 "batched engine:\n" + "\n".join(diffs[:10]))


def ftl_gc(prog: FleetProgram, batch: TraceBatch) -> tuple[dict, float]:
    """GC relocations (pages) per scheme over its lanes, read from the
    engine's raw lane outputs of one more replay of ``batch``, and the
    write amplification (host pages + relocated) / host pages."""

    out, _ = prog._replay(batch)
    reloc = {s: float(out["ftl_reloc_pages"][i * prog.num_nodes:(i + 1) * prog.num_nodes].sum())
             for i, s in enumerate(prog.schemes)}
    host = float(out["bytes_to_ssd"].sum()) / prog.ssd.page_size
    total = sum(reloc.values())
    return reloc, (host + total) / host if host else 1.0


def phase_ftl_sweep(dev: torch.device, batch: TraceBatch) -> dict:
    """The sweep with the page-mapped FTL SSD (``ssd="ftl"``): same trace,
    lanes and ``ssd_capacity`` and the same gates as :func:`phase_sweep`,
    then GC relocations and write amplification, and the device engine
    within ``DEVICE_TOLERANCES`` of the host batched engine with the FTL.
    The host engine charges the FTL one request at a time (its bit-parity
    contract), minutes of host time over the full trace, so that
    comparison alone runs on a trace cut to ``FTL_HOST_REQUESTS``
    requests, its capacity cut in proportion (half a node's share)."""

    t_phase = time.perf_counter()
    launches, _, _, _, prog, _, held = phase_sweep(dev, batch, ssd="ftl")
    per_scheme, wa = ftl_gc(prog, batch)
    reloc = sum(per_scheme.values())
    log(f"[ftl] GC relocations (ftl_reloc) {reloc:.1f} pages over all lanes "
        f"{json.dumps(per_scheme)}; write amplification {wa:.6f}")

    small = sweep_trace(FTL_HOST_REQUESTS)
    small_cap = small.total_bytes // 2 // SWEEP_NODES
    log(f"[ftl] cut: the host-engine comparison runs on {FTL_HOST_REQUESTS:,} of the "
        f"{batch.num_requests:,} requests (sweep_trace({FTL_HOST_REQUESTS})), "
        f"ssd_capacity {small_cap} (half a node's share, as in the full sweep)")
    t0 = time.perf_counter()
    small_prog = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES, policy="range-offset",
                              ssd_capacity=small_cap, ssd="ftl", device=dev)
    on_card = small_prog.run(small)
    t_card = time.perf_counter() - t0
    small_reloc, small_wa = ftl_gc(small_prog, small)
    t0 = time.perf_counter()
    host = {s: FleetSimulator(num_nodes=SWEEP_NODES, scheme=s, policy="range-offset",
                              ssd_capacity=small_cap, ssd="ftl", engine="batched",
                              device=dev).run(small) for s in SCHEMES}
    t_host = time.perf_counter() - t0
    within_device_tolerances("ftl cut", host, on_card)
    log(f"[ftl] cut: FleetProgram within DEVICE_TOLERANCES of FleetSimulator("
        f"engine='batched', ssd='ftl') over all {len(SCHEMES) * SWEEP_NODES} node "
        f"replays; GC relocations {sum(small_reloc.values()):.1f} pages, write "
        f"amplification {small_wa:.6f}; FleetProgram {t_card:.2f} s, host {t_host:.2f} s")
    log(f"[ftl] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "reloc": reloc, "wa": wa, "held": held}


def phase_host_engines(dev: torch.device, batch: TraceBatch, swept: dict,
                       t_sweep: float) -> dict:
    """The host replay engines: ``FleetSimulator(engine="batched")`` over
    every node and scheme of the sweep, scoring on the card, held against
    the sweep's ``FleetProgram`` within ``DEVICE_TOLERANCES``;
    ``run_schemes`` with the device and the batched engine on both golden
    workloads (card equal to the CPU); the 16 golden fixtures replayed
    exactly through the batched engine."""

    t_phase = time.perf_counter()
    cap = sweep_capacity(batch)
    ops.reset_launches()
    t0 = time.perf_counter()
    host = {s: FleetSimulator(num_nodes=SWEEP_NODES, scheme=s, policy="range-offset",
                              ssd_capacity=cap, engine="batched", score_backend="kernel",
                              device=dev).run(batch) for s in SCHEMES}
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    launches = dict(ops.launches)
    if launches["stream_stats"] != len(SCHEMES):
        fail(f"FleetSimulator: stream_stats launched {launches['stream_stats']} times, "
             f"expected {len(SCHEMES)} (one per run, all shards at once)")
    conserved("FleetSimulator", host, batch.total_bytes)
    within_device_tolerances("sweep", host, swept)
    log(f"[host] FleetSimulator(engine='batched') {SWEEP_NODES} nodes x {len(SCHEMES)} "
        f"schemes: {t_host:.2f} s (the sweep's FleetProgram: best {t_sweep:.3f} s); "
        f"FleetProgram within DEVICE_TOLERANCES of it; launches {json.dumps(launches)}")
    replay_ops.reset_launches()
    for wl in golden.FIXTURE_WORKLOADS:
        gb = golden_trace(wl)
        kw = dict(ssd_capacity=golden._node_capacity(gb.total_bytes))
        t0 = time.perf_counter()
        runs = {eng: run_schemes(gb, engine=eng, device=dev, **kw)
                for eng in ("device", "batched")}
        t_runs = time.perf_counter() - t0
        numpy_cpu = run_schemes(gb, engine="batched", score_backend="numpy", device="cpu", **kw)
        device_cpu = run_schemes(gb, engine="device", device="cpu", **kw)
        for s in SCHEMES:
            if golden.sim_result_to_dict(runs["batched"][s]) != \
                    golden.sim_result_to_dict(numpy_cpu[s]):
                fail(f"run_schemes {wl} {s}: batched engine on the card differs from the CPU")
        wrap = lambda d: {s: FleetResult(s, "-", 1, (r,)) for s, r in d.items()}  # noqa: E731
        worst = same_within(f"run_schemes {wl} device", wrap(runs["device"]), wrap(device_cpu))
        conserved(f"run_schemes {wl}", {**wrap(runs["device"])}, gb.total_bytes)
        conserved(f"run_schemes {wl}", {**wrap(runs["batched"])}, gb.total_bytes)
        io = {eng: {s: r.io_seconds for s, r in d.items()} for eng, d in runs.items()}
        log(f"[host] run_schemes {wl}: batched on the card == CPU exactly, device "
            f"engine card == cpu (clocks {worst:.3g}); io_seconds {json.dumps(io)} "
            f"({t_runs:.2f} s)")
    launches["replay"] = replay_ops.launches["replay"]
    if launches["replay"] != len(golden.FIXTURE_WORKLOADS) * len(SCHEMES):
        fail(f"run_schemes(engine='device'): replay launched {launches['replay']} times, "
             f"expected {len(golden.FIXTURE_WORKLOADS) * len(SCHEMES)} (one a scheme)")
    t0 = time.perf_counter()
    for scheme, wl, policy in ((s, w, p) for s in golden.FIXTURE_SCHEMES
                               for w in golden.FIXTURE_WORKLOADS
                               for p in golden.FIXTURE_POLICIES):
        payload = golden.load_fixture(golden.GOLDEN_DIR / golden.fixture_name(scheme, wl, policy))
        diffs = golden.check_fixture(payload, golden.replay_fixture(payload, device=dev))
        if diffs:
            fail(f"{scheme}__{wl}__{policy} through FleetSimulator(engine='batched'):\n"
                 + "\n".join(diffs))
    log(f"[host] 16 golden fixtures replayed exactly through FleetSimulator("
        f"engine='batched') on the card ({time.perf_counter() - t0:.2f} s)")
    log(f"[host] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "seconds": t_host, "results": host}


# -- the online service ---------------------------------------------------

SERVICE_SCHEMES = SCHEMES
# (a) the reference's service benchmark at its default size: four IOR apps
# of 512 MiB, 256 KiB requests, Poisson arrivals at 2,000 req/s, 8 nodes
SERVICE_A_APP_BYTES = 512 * MiB
SERVICE_A_RATE, SERVICE_A_NODES = 2000.0, 8
# (b) the sweep's trace, served: Poisson arrivals at 50,000 req/s, 64 nodes
SERVICE_B_RATE = 50_000.0
CRASH_KW = dict(heartbeat_timeout=2.0, epoch_seconds=0.5)


def service_load_a() -> TraceBatch:
    """``benchmarks/bench_service.py``'s offered load at 2 GiB."""

    apps = [
        relabel(ior("segmented-contiguous", 8, total_bytes=SERVICE_A_APP_BYTES, seed=1),
                app_id=0, file_id=0),
        relabel(ior("segmented-random", 8, total_bytes=SERVICE_A_APP_BYTES, seed=2),
                app_id=1, file_id=1),
        relabel(ior("strided", 32, total_bytes=SERVICE_A_APP_BYTES, seed=3),
                app_id=2, file_id=2),
        relabel(ior("segmented-random", 16, total_bytes=SERVICE_A_APP_BYTES, seed=4),
                app_id=3, file_id=3),
    ]
    load = mixed(*apps, burst_requests=512)
    return poisson_arrivals(TraceBatch.from_items(load.trace), rate_rps=SERVICE_A_RATE, seed=7)


class ScoringCalls:
    """Within the block, every scoring call of the service (one launch of
    the stream kernel each) is timed with CUDA events and its batches
    kept; the service's own function is put back on leaving."""

    def __enter__(self):
        self.calls = []
        self.real = service_loop._score_shards_kernel

        def timed(batches, stream_len, device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(batches, stream_len, device)
            end.record()
            end.synchronize()
            self.calls.append({"batches": list(batches), "ms": start.elapsed_time(end),
                               "rows": sum(len(sc) for sc in out)})
            return out

        service_loop._score_shards_kernel = timed
        return self

    def __exit__(self, *exc):
        service_loop._score_shards_kernel = self.real


def serve_once(dev: torch.device, label: str, batch: TraceBatch, **kw) -> dict:
    """One service run on the card, held to its gates: the byte ledger
    conserved (gate 1), ``stream_stats`` launched once plus once a
    resharding failover (gate 3), and the same ``ServiceResult`` from the
    run scored by the NumPy oracle (gate 4).  Returns the result, its
    numbers and the scoring calls."""

    svc = ReshardCountingService(device=dev, **kw)
    ops.reset_launches()
    with ScoringCalls() as scoring:
        t0 = time.perf_counter()
        res = svc.run(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    m = res.metrics
    violations = m.conservation_violations()
    if violations:
        fail(f"[service] {label}: byte ledger violated: {violations}")
    if launches["stream_stats"] != 1 + svc.reshards or len(scoring.calls) != 1 + svc.reshards:
        fail(f"[service] {label}: stream_stats launched {launches['stream_stats']} times "
             f"({len(scoring.calls)} scoring calls), expected 1 + {svc.reshards} failovers "
             "that resharded pending windows")
    t0 = time.perf_counter()
    oracle = BurstBufferService(score_backend="numpy", device=dev, **kw).run(batch)
    t_oracle = time.perf_counter() - t0
    if not same_service_result(res, oracle):
        fail(f"[service] {label}: the kernel-scored run differs from score_backend='numpy'")
    out = {
        "wall_s": wall, "oracle_wall_s": t_oracle, "launches": launches["stream_stats"],
        "reshards": svc.reshards, "windows": sum(c["rows"] for c in scoring.calls),
        "scoring_call_ms": [c["ms"] for c in scoring.calls],
        "throughput_mbs": m.throughput_mbs, "p99_latency": m.p99_latency,
        "recovery_seconds": m.recovery_seconds, "makespan_seconds": m.makespan_seconds,
        "replayed_bytes": m.replayed_bytes, "stranded_bytes": m.stranded_bytes,
        "rebalanced_bytes": m.rebalanced_bytes, "redirected_bytes": m.redirected_bytes,
        "faults": [(f.kind, f.node, f.detected_at, f.recovered_at) for f in m.faults],
    }
    log(f"[service] {label}: {wall:.3f} s wall ({t_oracle:.3f} s scored by numpy), "
        f"{out['windows']} windows scored in {launches['stream_stats']} launch(es) "
        f"({svc.reshards} resharding failover(s)); scoring calls "
        f"{json.dumps(out['scoring_call_ms'])} ms = "
        f"{sum(out['scoring_call_ms']) / 1e3 / wall:.4%} of the wall; "
        f"throughput_mbs {m.throughput_mbs!r}, p99_latency {m.p99_latency!r} s, "
        f"recovery_seconds {m.recovery_seconds!r}, makespan_seconds {m.makespan_seconds!r}, "
        f"replayed {m.replayed_bytes}, stranded {m.stranded_bytes}, "
        f"rebalanced {m.rebalanced_bytes}, redirected {m.redirected_bytes} bytes; "
        f"faults {json.dumps(out['faults'])}")
    out["result"], out["first_call_batches"] = res, scoring.calls[0]["batches"]
    return out


def serve_schemes(dev: torch.device, tag: str, batch: TraceBatch, nodes: int, cap: int
                  ) -> dict:
    """Each scheme healthy, and with one crash on node ``nodes // 2`` at
    25 % of the arrival horizon; returns label -> :func:`serve_once`."""

    kw = dict(num_nodes=nodes, policy="range-offset", ssd_capacity=cap)
    crash = FaultInjector.crash_at(0.25 * float(batch.times[-1]), nodes // 2)
    runs = {}
    for s in SERVICE_SCHEMES:
        runs[f"{tag}_{s}_healthy"] = serve_once(dev, f"{tag} {s} healthy", batch, scheme=s, **kw)
        runs[f"{tag}_{s}_crash"] = serve_once(dev, f"{tag} {s} crash", batch, scheme=s,
                                              injector=crash, **CRASH_KW, **kw)
    return runs


def scoring_kernel_ms(dev: torch.device, batches: list[TraceBatch]) -> tuple[float, list]:
    """Device time of the stream kernel alone on a run's scoring matrix
    (raw launches in a CUDA graph), held bit-equal to its plain version
    first; returns the time and the matrix shape."""

    o_np, s_np, _ = one_launch_matrix(batches)
    o, s = torch.from_numpy(o_np).to(dev), torch.from_numpy(s_np).to(dev)
    held_to_plain(o, s, None, True, "service scoring matrix")
    return graph_ms(raw_launch(o, s, True)), list(o.shape)


def phase_service(dev: torch.device, sweep: TraceBatch, host_results: dict) -> dict:
    """The online service on the card, its windows scored by the stream
    kernel: (a) the reference's service benchmark and a scripted scenario
    with every fault kind, (b) the sweep's trace served on 64 nodes.  Gates
    in :func:`serve_once`, and (gate 2) each healthy run of (b) equal,
    node for node, to ``FleetSimulator(engine="batched")`` on the sweep."""

    t_phase = time.perf_counter()
    a = service_load_a()
    cap_a = max(a.total_bytes // 2 // SERVICE_A_NODES, 64 * MiB)
    horizon = float(a.times[-1])
    log(f"[service] (a) {a.num_requests:,} requests, {a.total_bytes} bytes over "
        f"{horizon:.3f} s, {SERVICE_A_NODES} nodes, range-offset, ssd_capacity {cap_a}")
    runs = serve_schemes(dev, "a", a, SERVICE_A_NODES, cap_a)
    script = scripted((0.6 * horizon, "crash", 3), (0.1 * horizon, "slow", 2, 3.0),
                      (0.1 * horizon, "ssd_degrade", 6, 0.5),
                      (0.3 * horizon, "stall", 1, 1.0, 4.0))
    every = serve_once(dev, "a every fault kind (ssdup+, ftl)", a, scheme="ssdup+", ssd="ftl",
                       num_nodes=SERVICE_A_NODES, policy="range-offset", ssd_capacity=cap_a,
                       injector=script, replay=True, admission_occupancy=0.9,
                       admission_action="redirect", **CRASH_KW)
    kinds = {f[0] for f in every["faults"]}
    stall = [f for f in every["faults"] if f[0] == "stall"]
    if (kinds != {"crash", "slow", "ssd_degrade", "stall"} or not every["rebalanced_bytes"]
            or not every["redirected_bytes"] or not every["replayed_bytes"]
            or not stall or stall[0][3] is None):
        fail("[service] the scripted scenario did not exercise every fault kind, a "
             "rebalance, admission redirect, backlog replay and a rejoin")
    runs["a_every_fault_kind"] = every

    b = poisson_arrivals(sweep, rate_rps=SERVICE_B_RATE, seed=7)
    cap_b = sweep_capacity(b)
    log(f"[service] (b) {b.num_requests:,} requests, {b.total_bytes} bytes offered at "
        f"{SERVICE_B_RATE:.0f} req/s ({b.total_bytes / float(b.times[-1]) / 1e9:.3f} GB/s) "
        f"over {float(b.times[-1]):.3f} s, {SWEEP_NODES} nodes, range-offset, "
        f"ssd_capacity {cap_b}")
    runs_b = serve_schemes(dev, "b", b, SWEEP_NODES, cap_b)
    for s in SERVICE_SCHEMES:
        res = runs_b[f"b_{s}_healthy"]["result"]
        if res.metrics.rebalanced_bytes:
            # no fault was injected, but the straggler rule fired on the
            # lanes' own imbalance and moved windows, so the lanes' work is
            # not the offline fleet's: hold the identity on the same run
            # with the straggler rule off
            log(f"[service] (b) {s} healthy: the straggler rule moved "
                f"{res.metrics.rebalanced_bytes} bytes; the identity is held on the same run "
                "with straggler_factor=inf")
            res = BurstBufferService(scheme=s, num_nodes=SWEEP_NODES, policy="range-offset",
                                     ssd_capacity=cap_b, straggler_factor=math.inf,
                                     device=dev).run(b)
            if res.metrics.rebalanced_bytes or res.metrics.conservation_violations():
                fail(f"[service] (b) {s}: a run without the straggler rule rebalanced or "
                     "broke its ledger")
        if res.node_results != host_results[s].node_results:
            fail(f"[service] (b) {s} healthy: node results differ from "
                 "FleetSimulator(engine='batched') on the sweep")
    log("[service] (b) every healthy run's node results (without rebalancing) == "
        "FleetSimulator(engine='batched') on the sweep, bit for bit")
    runs.update(runs_b)

    kernel_ms = {}
    for tag in ("a", "b"):
        run = runs[f"{tag}_ssdup+_healthy"]
        ms, shape = scoring_kernel_ms(dev, run["first_call_batches"])
        kernel_ms[tag] = {"kernel_ms": ms, "shape": shape,
                          "share_of_wall": ms / 1e3 / run["wall_s"],
                          "scoring_call_ms": run["scoring_call_ms"][0]}
        log(f"[service] ({tag}) the scoring launch of a healthy run: kernel {ms:.4f} ms on "
            f"{shape} = {ms / 1e3 / run['wall_s']:.5%} of the run's {run['wall_s']:.3f} s "
            f"wall; the whole scoring call (matrix, copies, readback) "
            f"{run['scoring_call_ms'][0]:.3f} ms")
    summary = {k: {f: v for f, v in r.items() if f not in ("result", "first_call_batches")}
               for k, r in runs.items()}
    log(f"[service] runs {json.dumps(summary)}")
    log(f"[service] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {k: r["launches"] for k, r in runs.items()}, "kernel": kernel_ms}


def phase_any_len_sweeps(dev: torch.device, batch: TraceBatch) -> dict:
    """The sweep at ``stream_len`` 96 (the kernel's padded branch) and 2048
    (its long-row kernel, no row by its exact branch: the trace's rows
    need at most one repair round), each launching ``stream_stats`` once
    and equal, field for field, to the same sweep scored by the NumPy
    oracle."""

    t_phase = time.perf_counter()
    cap = sweep_capacity(batch)
    out = {}
    for stream_len in (96, 2048):
        ops.reset_launches()
        replay_ops.reset_launches()
        kernel.long_rows(reset=True)
        kernel.long_wide_rows(reset=True)
        t0 = time.perf_counter()
        res = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES, policy="range-offset",
                           stream_len=stream_len, ssd_capacity=cap, device=dev).run(batch)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches = dict(ops.launches, **replay_ops.launches)
        one_replay("[any-len]", f"the stream_len={stream_len} sweep", launches["replay"])
        long = kernel.long_rows(reset=True)
        exact = kernel.long_wide_rows(reset=True)
        if exact:
            fail(f"stream_len={stream_len}: {exact} rows in the long-row kernel's exact branch")
        if launches["stream_stats"] != 1:
            fail(f"stream_len={stream_len}: stream_stats launched "
                 f"{launches['stream_stats']} times, expected 1")
        if (long > 0) != (stream_len > 1024):
            fail(f"stream_len={stream_len}: {long} rows in the long-row kernel")
        conserved(f"stream_len={stream_len}", res, batch.total_bytes)
        oracle = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES, policy="range-offset",
                              stream_len=stream_len, ssd_capacity=cap, score_backend="numpy",
                              device=dev).run(batch)
        for s in SCHEMES:
            if golden.fleet_result_to_dict(res[s]) != golden.fleet_result_to_dict(oracle[s]):
                fail(f"stream_len={stream_len} {s}: kernel scoring differs from numpy")
        log(f"[any-len] stream_len={stream_len}: first call {t_first:.3f} s, launches "
            f"{json.dumps(launches)}, {long} rows in the long-row kernel ({exact} by its "
            "exact branch); equal to score_backend='numpy'")
        out[stream_len] = {"launches": launches, "long_rows": long, "long_wide_rows": exact}
    log(f"[any-len] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- the user entry points: the examples and the anomaly hunt ----------------

EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
EXAMPLES_GOLDEN = os.path.join(ROOT, "tests", "golden_torch", "examples")
HOST_EXAMPLES = ("quickstart", "fleet_sim", "service_failover", "elastic_recovery")
HUNT_SCRIPT = os.path.join(ROOT, "experiments", "anomaly_hunt_torch.py")
HUNT_CSV = os.path.join(ROOT, "experiments", "anomaly_hunt.csv")
# batched_replay's --requests: a quarter of the reference's 1,000,000 (its default),
# cut for the script's time: at 1,000,000 its AVL leg took 26.3 s and the script
# 900.6 s on one H100 host
EXAMPLES_REPLAY_REQUESTS = 250_000
EXAMPLES_TRAIN_STEPS = 120  # train_checkpointed's --steps (its default)


def load_script(path: str) -> types.ModuleType:
    """A script of the repo, loaded by path (they are not packages)."""

    name = "script_" + os.path.splitext(os.path.relpath(path, ROOT))[0].replace(os.sep, "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class CountedRuns:
    """Within the block, ``FleetSimulator.run`` calls are counted and the
    service's instances kept (each counting its resharding failovers); the
    real class and method are put back on leaving."""

    def __enter__(self):
        self.fleet_runs, self.services = 0, []
        self.real_run, self.real_service = FleetSimulator.run, service_loop.BurstBufferService
        outer = self

        def run(fleet, *args, **kw):
            outer.fleet_runs += 1
            return outer.real_run(fleet, *args, **kw)

        class Recorded(ReshardCountingService):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                outer.services.append(self)

        FleetSimulator.run = run
        service_loop.BurstBufferService = Recorded
        return self

    def __exit__(self, *exc):
        FleetSimulator.run = self.real_run
        service_loop.BurstBufferService = self.real_service


def run_script(label: str, main, argv: list) -> dict:
    """``main(argv)`` of a port script on the card, its stdout captured and
    echoed, with every kernel's launches and the fleet runs counted from
    zero; returns what it returned, printed, launched and took."""

    ops.reset_launches()
    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    replay_ops.reset_launches()
    buf = io.StringIO()
    with CountedRuns() as counted, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.launches, **fa_ops.launches, **ssm_ops.launches, **replay_ops.launches)
    for line in buf.getvalue().splitlines():
        log(f"[examples]   {label} | {line}")
    log(f"[examples] {label}: {wall:.3f} s on the card; launches {json.dumps(launches)}, "
        f"{counted.fleet_runs} FleetSimulator.run call(s)")
    return {"out": out, "stdout": buf.getvalue(), "wall_s": wall, "launches": launches,
            "fleet_runs": counted.fleet_runs,
            "reshards": sum(svc.reshards for svc in counted.services),
            "service_runs": len(counted.services)}


def only_launches(label: str, launches: dict, want: dict) -> None:
    """Exactly ``want``'s launches of each kernel, and none of the others."""

    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        fail(f"[examples] {label}: launches {json.dumps(got)}, expected {json.dumps(want)}")


def serve_against_plain(kernel: dict) -> None:
    """``serve_batched``'s run on the kernels against the same script on the
    layers' torch paths (its ``get_smoke_config`` swapped for one that says
    ``attention_impl``/``ssm_impl="torch"``), on the same seeded weights and
    prompts: each row's last-position logits within ``BF16_TOL`` for every
    step fed the same tokens, and where a bf16 near-tie flips a token, the
    plain logits' margin between the two tokens within ``BF16_TOL`` too (the
    rule of ``tests/test_torch_examples.py`` against the reference)."""

    mod = load_script(os.path.join(EXAMPLES_DIR, "serve_batched.py"))
    mod.get_smoke_config = lambda arch: dataclasses.replace(
        get_smoke_config(arch), attention_impl="torch", ssm_impl="torch")
    plain = run_script("serve_batched on the torch paths",
                       lambda argv: {arch: mod.serve(arch, None) for arch in mod.ARCHS}, [])
    only_launches("serve_batched on the torch paths", plain["launches"], {})
    for arch in mod.ARCHS:
        got, want = kernel[arch], plain["out"][arch]
        err, margins = 0.0, []
        for b in range(mod.BATCH):
            flips = torch.nonzero(got["tokens"][b] != want["tokens"][b]).flatten().tolist()
            upto = flips[0] + 1 if flips else mod.GEN  # the steps fed the same tokens
            err = max(err, _held(f"[examples] serve_batched {arch} row {b}: kernel vs torch "
                                 "paths' logits", got["logits"][b, :upto],
                                 want["logits"][b, :upto], BF16_TOL, BF16_TOL))
            if flips:
                t = flips[0]
                lg = want["logits"][b, t]
                margin = float(lg[want["tokens"][b, t]] - lg[got["tokens"][b, t]])
                margins.append(margin)
                if not 0 <= margin <= BF16_TOL:
                    fail(f"[examples] serve_batched {arch} row {b}: token {t} flipped at a "
                         f"margin of {margin:.3g}")
        log(f"[examples] serve_batched {arch}: the kernels' logits within {BF16_TOL} of the "
            f"torch paths' (max |err| {err:.3g}); {len(margins)} row(s) flipped by a near-tie, "
            f"margins {margins}")


def phase_examples(dev: torch.device) -> dict:
    """The reference's user entry points as the port runs them on the card:
    each ``examples_torch`` script's and the anomaly hunt's ``main()`` in
    this process, without ``--device``.  Gates: the four host-deterministic
    examples print the committed texts (held equal to the reference's
    output by ``tests/test_torch_examples.py``); one ``stream_stats``
    launch a ``FleetSimulator.run`` (``fleet_sim``, the hunt), a scoring
    pass (``quickstart``, ``batched_replay``) and a service run plus one a
    resharding failover (``service_failover``); ``batched_replay``'s
    backends agreeing and its card scores equal to ``score_backend="numpy"``;
    ``serve_batched``'s kernels once a layer, its tokens below the padded
    vocabulary and its logits against its torch paths'
    (``serve_against_plain``); ``train_checkpointed``'s resume at its newest save
    before the crash and finite losses; the hunt's CSV byte-identical to
    ``experiments/anomaly_hunt.csv``."""

    t_phase = time.perf_counter()
    runs = {}
    for name in HOST_EXAMPLES:
        res = runs[name] = run_script(name, load_script(os.path.join(EXAMPLES_DIR, name + ".py"))
                                      .main, [])
        with open(os.path.join(EXAMPLES_GOLDEN, name + ".txt")) as f:
            if res["stdout"] != f.read():
                fail(f"[examples] {name}: stdout differs from the committed text")
    only_launches("quickstart", runs["quickstart"]["launches"], {"stream_stats": 1})
    fleet = runs["fleet_sim"]
    if fleet["fleet_runs"] != fleet["out"]["fleet_runs"] or fleet["fleet_runs"] != 7:
        fail(f"[examples] fleet_sim: {fleet['fleet_runs']} FleetSimulator.run calls")
    only_launches("fleet_sim", fleet["launches"], {"stream_stats": fleet["fleet_runs"]})
    svc = runs["service_failover"]
    if svc["service_runs"] != len(SCHEMES):
        fail(f"[examples] service_failover: {svc['service_runs']} service runs")
    only_launches("service_failover", svc["launches"],
                  {"stream_stats": svc["service_runs"] + svc["reshards"]})
    only_launches("elastic_recovery", runs["elastic_recovery"]["launches"], {})

    mod = load_script(os.path.join(EXAMPLES_DIR, "batched_replay.py"))
    res = runs["batched_replay"] = run_script(
        "batched_replay", mod.main, ["--requests", str(EXAMPLES_REPLAY_REQUESTS)])
    only_launches("batched_replay", res["launches"], {"stream_stats": 2})  # + the spot check
    oracle = compute_stream_scores(res["out"]["batch"], backend="numpy")
    for f in dataclasses.fields(oracle):
        got, want = getattr(res["out"]["scores"], f.name), getattr(oracle, f.name)
        if f.name != "backend" and not np.array_equal(got, want):
            fail(f"[examples] batched_replay: card scores' {f.name} differ from numpy")
    a, b = (res["out"]["results"][k] for k in ("numpy", "avl"))
    if dataclasses.asdict(a) != dataclasses.asdict(b):
        fail("[examples] batched_replay: the index backends disagree")
    log(f"[examples] batched_replay: {EXAMPLES_REPLAY_REQUESTS:,} requests, "
        f"{len(oracle):,} streams scored on the card equal to numpy; replay numpy "
        f"{res['out']['seconds']['numpy']:.3f} s, avl {res['out']['seconds']['avl']:.3f} s, "
        "backends equal field for field")

    mod = load_script(os.path.join(EXAMPLES_DIR, "serve_batched.py"))
    if (mod.BATCH, mod.PROMPT) != EXAMPLES_SERVE:
        fail(f"[examples] serve_batched prefills {(mod.BATCH, mod.PROMPT)}, the kernel cases "
             f"hold {EXAMPLES_SERVE}")
    res = runs["serve_batched"] = run_script("serve_batched", mod.main, [])
    want = {}
    for arch in mod.ARCHS:
        name, count = prefill_launches(get_smoke_config(arch))
        want[name] = want.get(name, 0) + count
        tokens = res["out"][arch]["tokens"]
        if tokens.shape != (mod.BATCH, mod.GEN) or not bool(
                ((tokens >= 0) & (tokens < res["out"][arch]["padded_vocab"])).all()):
            fail(f"[examples] serve_batched {arch}: bad tokens {tokens.tolist()}")
    only_launches("serve_batched", res["launches"], want)
    serve_against_plain(res["out"])

    mod = load_script(os.path.join(EXAMPLES_DIR, "train_checkpointed.py"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        res = runs["train_checkpointed"] = run_script(
            "train_checkpointed", mod.main,
            ["--steps", str(EXAMPLES_TRAIN_STEPS), "--ckpt-dir", root])
    out = res["out"]
    newest = EXAMPLES_TRAIN_STEPS // 2 // mod.SAVE_EVERY * mod.SAVE_EVERY  # before the crash
    if out["resumed_at"] != newest or not all(
            math.isfinite(v) for v in out["losses"].values()):
        fail(f"[examples] train_checkpointed: resumed at {out['resumed_at']}, "
             f"losses {out['losses']}")
    only_launches("train_checkpointed", res["launches"], {})  # the torch paths

    mod = load_script(HUNT_SCRIPT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hunt_") as tmp:
        csv = os.path.join(tmp, "anomaly_hunt.csv")
        res = runs["anomaly_hunt"] = run_script("anomaly_hunt", mod.main, ["--csv", csv])
        with open(csv, "rb") as got, open(HUNT_CSV, "rb") as want:
            if got.read() != want.read():
                fail("[examples] anomaly_hunt: the CSV differs from experiments/anomaly_hunt.csv")
    if res["out"] != 0 or res["fleet_runs"] != 86:
        fail(f"[examples] anomaly_hunt: rc {res['out']}, {res['fleet_runs']} fleet runs")
    only_launches("anomaly_hunt", res["launches"], {"stream_stats": res["fleet_runs"]})
    log("[examples] anomaly_hunt: the CSV is byte-identical to experiments/anomaly_hunt.csv")

    walls = {name: round(r["wall_s"], 4) for name, r in runs.items()}
    total = time.perf_counter() - t_phase
    log(f"[examples] walls (s) {json.dumps(walls)}; phase {total:.1f} s")
    launches = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"walls": walls, "launches": launches, "seconds": total}


# -- the fleet path with the sanitizer armed --------------------------------


def same_fleet(label: str, got: dict, want: dict) -> None:
    """Every field of every scheme's ``FleetResult`` bit-equal."""

    for s in want:
        if golden.fleet_result_to_dict(got[s]) != golden.fleet_result_to_dict(want[s]):
            fail(f"[sanitize] {label} {s}: the sanitized run differs from the unsanitized one")


def stream_launches(fn):
    """``fn()``'s result and the ``stream_stats`` launches it made."""

    ops.reset_launches()
    out = fn()
    return out, ops.launches["stream_stats"]


def phase_sanitize(dev: torch.device, batch: TraceBatch, golden_runs: dict, swept: dict,
                   prog: FleetProgram, sweep_times: dict) -> dict:
    """The fleet main path on the card with every sanitizer check armed.
    (a) the 16 golden fixtures through ``FleetProgram`` under
    ``sanitizing()``, bit-equal to :func:`phase_golden`'s unsanitized runs
    and within each fixture's ``device_tolerance``, one ``stream_stats``
    launch a program; (b) the sweep on :func:`phase_sweep`'s program (its
    tapes cached: no launch): one more call under ``sanitizing()``,
    bit-equal to :func:`phase_sweep`'s result, the output checks timed
    alone, and the steady times with checks off and on, best of 3 each,
    that :func:`phase_sweep` took in turns before its profiled and CPU
    runs (``sweep_times``); (c) a NaN in the
    first event of the golden ``mixed-burst`` tape: ``replay_lanes`` on the
    card raises ``SanitizerError`` (``non-finite``) when sanitized, and the
    NaN reaches ``io_seconds[0]`` when not; (d) ``FleetSimulator`` and
    ``BurstBufferService(score_backend="kernel")`` with ``sanitize=True``
    on service load (a), each bit-equal to its unsanitized twin, one launch
    a run (the shard-conservation and byte-ledger checks armed).  Returns
    the launches of each part and the timings."""

    t_phase = time.perf_counter()
    launches, out = {}, {}

    t0 = time.perf_counter()
    ops.reset_launches()
    replay_ops.reset_launches()
    for (wl, policy), plain in golden_runs.items():
        gb = golden_trace(wl)
        with sanitizing():
            checked = golden_program(dev, gb, policy).run(gb)
        same_fleet(f"(a) {wl} {policy}", checked, plain)
        for s, fr in checked.items():
            payload = golden.load_fixture(golden.fixture_path(s, wl, policy))
            diffs = golden.check_fixture(payload, fr, tolerances=payload["device_tolerance"])
            if diffs:
                fail(f"[sanitize] (a) {s}__{wl}__{policy}:\n" + "\n".join(diffs))
    launches["golden"] = ops.launches["stream_stats"]
    replays = {"golden": replay_ops.launches["replay"]}
    if replays["golden"] != len(golden_runs):
        fail(f"[sanitize] (a) replay launched {replays['golden']} times, expected "
             f"{len(golden_runs)} (one a program)")
    if launches["golden"] != len(golden_runs):
        fail(f"[sanitize] (a) stream_stats launched {launches['golden']} times, expected "
             f"{len(golden_runs)} (one a program)")
    log(f"[sanitize] (a) 16 golden fixtures sanitized on the card: every field bit-equal to "
        f"the unsanitized card runs, within device_tolerance; {launches['golden']} launches "
        f"for {len(golden_runs)} programs; {time.perf_counter() - t0:.2f} s")

    ops.reset_launches()
    replay_ops.reset_launches()
    with sanitizing():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prog.run(batch)
        torch.cuda.synchronize()
        t_late = time.perf_counter() - t0
    same_fleet("(b) sweep (checks on)", res, swept)
    launches["sweep"] = ops.launches["stream_stats"]
    replays["sweep"] = replay_ops.launches["replay"]
    one_replay("[sanitize] (b)", "the checked sweep call", replays["sweep"])
    if launches["sweep"] != 0:
        fail(f"[sanitize] (b) stream_stats launched {launches['sweep']} times on the sweep's "
             "cached tapes, expected 0 (its first call, in phase_sweep, launched once)")
    steady = {False: sweep_times["off"], True: sweep_times["on"]}
    off, on = min(steady[False]), min(steady[True])
    # the work the checks add, alone: replay_lanes' output checks on the
    # sweep's 256 lanes, on the card (each check reads one flag back)
    lanes = {f: torch.tensor([getattr(r, f) for s in SCHEMES for r in swept[s].node_results],
                             dtype=torch.float64 if f in CLOCK_FIELDS else torch.int64,
                             device=dev) for f in CLOCK_FIELDS + INT_FIELDS}
    ed._check_outputs(lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ed._check_outputs(lanes)
    checks_ms = (time.perf_counter() - t0) / 200 * 1e3
    out["sweep"] = {"steady_off_s": steady[False], "steady_on_s": steady[True],
                    "best_off_s": off, "best_on_s": on, "ratio": on / off,
                    "checks_ms": checks_ms, "late_on_s": t_late,
                    "after_s": sweep_times["after"]}
    log(f"[sanitize] (b) the sweep, {batch.num_requests:,} requests on {SWEEP_NODES} nodes x "
        f"{len(SCHEMES)} schemes, on phase_sweep's program: bit-equal to phase_sweep's result "
        f"with checks on and off; steady (in phase_sweep, before its profiled and cpu runs) "
        f"off {json.dumps(steady[False])} s, on {json.dumps(steady[True])} s; best off "
        f"{off:.4f} s, on {on:.4f} s, ratio {on / off:.4f}; the output checks alone "
        f"{checks_ms:.4f} ms a call ({checks_ms / 1e3 / off:.4%} of the best unchecked call); "
        f"one checked call here {t_late:.4f} s; launches {launches['sweep']}")

    gb = golden_trace("mixed-burst")
    scores, launches["seeded_nan"] = stream_launches(
        lambda: compute_stream_scores(gb, device=dev))
    tape = ed.build_events(gb, scores)
    net_t = tape["net_t"].copy()
    net_t[0] = np.nan  # a NaN smuggled into a valid event
    tape["net_t"] = net_t
    args = (ed.stack_events([tape]),
            ed._stack_lanes([ed.lane_consts("ssdup+", golden._node_capacity(gb.total_bytes))]),
            ed._stack_lanes([ed.initial_lane_state("ssdup+", 64)]))
    replay_ops.reset_launches()
    with sanitizing():
        try:
            ed.replay_lanes(*args, device=dev)
        except sanitize.SanitizerError as err:
            caught = str(err)
        else:
            fail("[sanitize] (c) a NaN in the tape replayed on the card under sanitizing() "
                 "raised nothing")
    if "non-finite" not in caught:
        fail(f"[sanitize] (c) the NaN raised {caught!r}, expected a non-finite clock")
    with sanitizing(False):
        io = ed.replay_lanes(*args, device=dev)["io_seconds"]
    if not np.isnan(io[0]):
        fail(f"[sanitize] (c) unsanitized, the NaN did not reach io_seconds: {io[0]!r}")
    replays["seeded_nan"] = replay_ops.launches["replay"]
    if replays["seeded_nan"] != 2:
        fail(f"[sanitize] (c) replay launched {replays['seeded_nan']} times, expected 2")
    log(f"[sanitize] (c) NaN in net_t[0] of the mixed-burst tape on the card, through the "
        f"replay kernel: sanitized raises SanitizerError({caught!r}); unsanitized "
        f"io_seconds[0] = {io[0]!r}")

    a = service_load_a()
    kw = dict(num_nodes=SERVICE_A_NODES, policy="range-offset",
              ssd_capacity=max(a.total_bytes // 2 // SERVICE_A_NODES, 64 * MiB), device=dev)
    launches["fleet_simulator"] = launches["service"] = 0
    walls = {}
    for s in SCHEMES:
        runs = {}
        for checked in (False, True):
            t0 = time.perf_counter()
            fleet, n = stream_launches(lambda: FleetSimulator(
                scheme=s, score_backend="kernel", sanitize=checked, **kw).run(a))
            t_fleet = time.perf_counter() - t0
            launches["fleet_simulator"] += n
            svc = BurstBufferService(scheme=s, score_backend="kernel", sanitize=checked, **kw)
            if svc.sanitize != checked:
                fail(f"[sanitize] (d) the service's sanitize flag is {svc.sanitize}")
            t0 = time.perf_counter()
            served, n = stream_launches(lambda: svc.run(a))
            t_service = time.perf_counter() - t0
            launches["service"] += n
            runs[checked] = (fleet, served)
            walls[f"{s}_{'on' if checked else 'off'}"] = {"fleet_simulator_s": t_fleet,
                                                           "service_s": t_service}
        same_fleet(f"(d) FleetSimulator {s}", {s: runs[True][0]}, {s: runs[False][0]})
        if not same_service_result(runs[True][1], runs[False][1]):
            fail(f"[sanitize] (d) BurstBufferService {s}: the sanitized run differs from the "
                 "unsanitized one")
    runs_d = 2 * len(SCHEMES)
    if launches["fleet_simulator"] != runs_d or launches["service"] != runs_d:
        fail(f"[sanitize] (d) stream_stats launched {launches['fleet_simulator']} times by "
             f"FleetSimulator and {launches['service']} by the service, expected {runs_d} each "
             "(one a run)")
    out["load_a"] = walls
    log(f"[sanitize] (d) service load (a), {a.num_requests:,} requests on {SERVICE_A_NODES} "
        f"nodes: FleetSimulator and BurstBufferService(score_backend='kernel') with "
        f"sanitize=True bit-equal to their unsanitized twins for every scheme; one launch a "
        f"run; walls (s) {json.dumps(walls)}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[sanitize] launches {json.dumps(launches)}, replay {json.dumps(replays)}")
    log(f"[sanitize] phase {out['phase_s']:.1f} s")
    return {"launches": launches, "replay_launches": replays, **out}


# -- model kernels and the serve path ---------------------------------------

# the prefill attention of each served arch: (b, h, kv, s, hd), causal
FA_SERVE = {
    "qwen3-1.7b": (SERVE_BATCH, 16, 8, SERVE_PROMPT, 128),
    "stablelm-3b": (SERVE_BATCH, 32, 32, SERVE_PROMPT, 80),  # zamba2-2.7b's shared block too
    "phi4-mini-3.8b": (SERVE_BATCH, 24, 8, SERVE_PROMPT, 128),
    "starcoder2-3b": (SERVE_BATCH, 24, 2, SERVE_PROMPT, 128),
    "moonshot-v1-16b-a3b": (SERVE_BATCH, 16, 16, SERVE_PROMPT, 128),
    "internvl2-26b": (SERVE_BATCH, 48, 8, SERVE_PROMPT, 128),  # grok-1-314b's too
}
# whisper-tiny: the encoder's non-causal attention over 1,500 frames and the
# decoder's causal prefill, hd 64: (b, h, kv, sq, sk, hd, causal)
WHISPER_ENCODER = (SERVE_BATCH, 6, 6, 1500, 1500, 64, False)
WHISPER_DECODER = (SERVE_BATCH, 6, 6, PROMPT_OF["whisper-tiny"], PROMPT_OF["whisper-tiny"], 64,
                   True)
# examples_torch/serve_batched.py's prefill: 4 prompts of 24 tokens through
# the smoke configs of qwen3-1.7b (attention at hd 16) and falcon-mamba-7b
EXAMPLES_SERVE = (4, 24)  # its BATCH, PROMPT; phase_examples checks them
_EX_ATTN, _EX_SCAN = get_smoke_config("qwen3-1.7b"), get_smoke_config("falcon-mamba-7b")
EXAMPLES_FA = (*EXAMPLES_SERVE[:1], _EX_ATTN.n_heads, _EX_ATTN.n_kv_heads,
               EXAMPLES_SERVE[1], EXAMPLES_SERVE[1], _EX_ATTN.head_dim_, True)
EXAMPLES_SSM = (*EXAMPLES_SERVE, _EX_SCAN.expand * _EX_SCAN.d_model, _EX_SCAN.ssm_state,
                min(512, _EX_SCAN.expand * _EX_SCAN.d_model),  # layers.py's block_d
                min(_EX_SCAN.scan_chunk, EXAMPLES_SERVE[1]))
# the shapes a served prefill gives the kernel, held in the model's layout
FA_MODEL_SHAPES = [(b, h, kv, s, s, hd, True) for b, h, kv, s, hd in FA_SERVE.values()] + [
    WHISPER_ENCODER, WHISPER_DECODER, EXAMPLES_FA]
FA_CASES = [  # (b, h, kv, sq, sk, hd, causal)
    (1, 2, 2, 128, 128, 64, True),   # the grid of tests/test_kernels.py
    (2, 4, 2, 128, 128, 64, True),
    (1, 6, 1, 128, 128, 32, True),
    (1, 2, 2, 256, 256, 128, False),
    (1, 2, 2, 64, 192, 64, False),
    (1, 8, 1, 256, 256, 128, True),  # MQA
    (2, 4, 2, 100, 77, 128, True),   # ragged, Sq > Sk
    (1, 3, 1, 77, 130, 32, False),   # ragged, Sq < Sk
    (1, 4, 4, 33, 33, 16, True),
    # every head dim of the bf16 tensor-core kernel on ragged lengths
    (1, 4, 2, 300, 200, 16, True),
    (1, 4, 2, 300, 200, 32, True),
    (1, 4, 2, 300, 200, 64, True),
    (1, 4, 2, 300, 200, 128, True),
    (2, 2, 1, 200, 333, 64, False),
    # hd 80 (stablelm-3b, zamba2-2.7b): MHA and GQA, causal and not, ragged
    (1, 4, 4, 300, 200, 80, True),
    (1, 4, 4, 256, 256, 80, False),
    (2, 6, 2, 200, 333, 80, False),
    (2, 4, 2, 100, 77, 80, True),
] + FA_MODEL_SHAPES
SSM_CASES = [  # (b, s, di, n, block_d, chunk)
    (1, 32, 16, 4, 16, 16),    # the grid of tests/test_kernel_ssm_scan.py
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 64, 32),
    (3, 96, 48, 8, 16, 32),
    (2, 40, 24, 16, 24, 8),    # DI not a multiple of the 128-channel block
    (2, 100, 200, 1, 200, 100),  # N = 1, 2 and 32; S not a multiple of the 32-step chunk
    (2, 100, 200, 2, 40, 50),
    (2, 96, 200, 32, 100, 32),
    (1, 70, 37, 4, 37, 70),    # DI not a multiple of 8: plain loads, no 16-byte copies
    EXAMPLES_SSM,              # serve_batched's falcon-mamba-7b smoke prefill
    (SERVE_BATCH, SERVE_PROMPT, 8192, 16, 512, 256),  # falcon-mamba-7b prefill
]


def fa_inputs(dev, b, h, kv, sq, sk, hd, dtype, seed=0, bshd=False):
    """q, k, v from N(0, 1); ``bshd``: the model's (B, S, H, hd) layout."""

    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = (((b, sq, h, hd), (b, sk, kv, hd)) if bshd
              else ((b, h, sq, hd), (b, kv, sk, hd)))
    q = torch.randn(shapes[0], generator=g, device=dev).to(dtype)
    k = torch.randn(shapes[1], generator=g, device=dev).to(dtype)
    v = torch.randn(shapes[1], generator=g, device=dev).to(dtype)
    return q, k, v


def ssm_inputs(dev, b, s, di, n, xdtype, seed=0):
    """The distributions of tests/test_kernel_ssm_scan.py::make."""

    g = torch.Generator(device=dev).manual_seed(seed)
    delta = (torch.randn(b, s, di, generator=g, device=dev) * 0.1).abs()
    B = torch.randn(b, s, n, generator=g, device=dev)
    C = torch.randn(b, s, n, generator=g, device=dev)
    x = torch.randn(b, s, di, generator=g, device=dev).to(xdtype)
    A = -(1 + 0.3 * torch.randn(di, n, generator=g, device=dev)).abs()
    return delta, B, C, x, A


def _held(label: str, got, want, atol: float, rtol: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        fail(f"{label}: outside atol {atol}, rtol {rtol} (max |err| {err:.3g})")
    return err


def fa_instance(hd: int) -> str:
    """The attention kernel's row in the kernels line: its hd-80 instance
    (five 32-byte swizzle blocks a row, ``m64n80k16``) and its hd-64 one
    (whisper-tiny's) apart."""

    return {80: "flash_attention_hd80", 64: "flash_attention_hd64"}.get(hd, "flash_attention")


def check_model_kernels(dev: torch.device) -> dict[str, float]:
    """``flash_attention`` and ``ssm_scan`` against their plain versions on
    the card; returns each kernel's (and the hd-80 instance's) largest
    |error| over the cases."""

    worst = {"flash_attention": 0.0, "flash_attention_hd80": 0.0, "flash_attention_hd64": 0.0,
             "ssm_scan": 0.0}
    for i, (b, h, kv, sq, sk, hd, causal) in enumerate(FA_CASES):
        serve_shape = (b, h, kv, sq, sk, hd, causal) in FA_MODEL_SHAPES
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = fa_inputs(dev, b, h, kv, sq, sk, hd, dtype, seed=i, bshd=serve_shape)
            if serve_shape:  # the model's layout, as prefill calls it
                got = fa_ops.flash_attention_bshd(q, k, v, causal=causal).transpose(1, 2)
                q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            else:
                got = fa_ops.flash_attention_op(q, k, v, causal=causal)
            want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
            err = _held(f"flash_attention {(b, h, kv, sq, sk, hd, causal)} {dtype}",
                        got, want, FA_TOL[dtype], FA_TOL[dtype])
            worst[fa_instance(hd)] = max(worst[fa_instance(hd)], err)
            if (b, h, kv, sq, sk, hd, causal) == EXAMPLES_FA:
                log(f"[kernels] flash_attention at serve_batched's prefill {EXAMPLES_FA} "
                    f"{dtype}: max |err| {err:.3g}")
    log(f"[kernels] flash_attention: {2 * len(FA_CASES)} cases within 2e-5 (f32) / "
        f"2e-2 (bf16) of the plain version, max |err| {worst['flash_attention']:.3g}, "
        f"at hd 80 {worst['flash_attention_hd80']:.3g}, at hd 64 "
        f"{worst['flash_attention_hd64']:.3g}")

    for i, (b, s, di, n, bd, ck) in enumerate(SSM_CASES):
        for xdtype in (torch.float32, torch.bfloat16):
            args = ssm_inputs(dev, b, s, di, n, xdtype, seed=i)
            y, h = ssm_ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
            yr, hr = ssm_ref.ssm_scan_ref(*args)
            label = f"ssm_scan {(b, s, di, n)} x {xdtype}"
            tol = SSM_TOL[xdtype]
            err = _held(label + " y", y, yr, tol, tol)
            worst["ssm_scan"] = max(worst["ssm_scan"], err,
                                    _held(label + " h_last", h, hr, 1e-3, 1e-3))
            if (b, s, di, n, bd, ck) == EXAMPLES_SSM:
                log(f"[kernels] ssm_scan at serve_batched's prefill {EXAMPLES_SSM} x {xdtype}: "
                    f"max |err| of y {err:.3g}")
    b, s, di, n, bd, ck = SSM_CASES[-1]
    args = ssm_inputs(dev, b, s, di, n, torch.bfloat16, seed=99)
    y0, h0 = ssm_ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
    for bd2, ck2 in ((di, s), (64, 16), (8192, 1)):
        y2, h2 = ssm_ops.ssm_scan_op(*args, block_d=bd2, chunk=ck2)
        if not (torch.equal(y0, y2) and torch.equal(h0, h2)):
            fail(f"ssm_scan result depends on (block_d, chunk) = ({bd2}, {ck2})")
    log(f"[kernels] ssm_scan: {2 * len(SSM_CASES)} cases within 1e-4 (f32) / 3e-2 "
        f"(bf16) for y and 1e-3 for h_last, max |err| {worst['ssm_scan']:.3g}; "
        "bit-equal under 4 (block_d, chunk) choices at the serve shape")
    return worst


def _agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def prefill_launches(cfg) -> tuple[str, int]:
    """The kernel a prefill of ``cfg`` launches, and how often: attention
    once a layer (dense, MoE, VLM), once an encoder and once a decoder
    layer (encoder-decoder; cross attention runs the torch path, as the
    reference's never reaches its kernel), or once a shared-attention
    application (hybrid: once a group of ``shared_attn_every`` Mamba-2
    layers, whose scan has no kernel in either package); the scan once a
    layer (Mamba-1)."""

    if cfg.family == "ssm":
        return "ssm_scan", cfg.n_layers
    if cfg.family == "hybrid":
        return "flash_attention", cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return "flash_attention", cfg.encoder_layers + cfg.n_layers
    return "flash_attention", cfg.n_layers


def serve_config(arch: str):
    """``arch``'s published config, its depth cut where ``SERVE_DEPTH`` says."""

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg


def forward_len(cfg, prompt: int) -> int:
    """Tokens of a decode-against-forward check: the prompt, or one scan
    chunk where the scan kernel needs S divisible by min(scan_chunk, S) at
    both S and S - 1."""

    return cfg.scan_chunk if cfg.family in ("ssm", "hybrid") else prompt


def decode_config(cfg):
    """The config decode against forward runs at.  A MoE decode step routes
    groups of one token, while a prefill at the published group of 256
    needs S divisible by 256 (2,047 is not) and drops choices past capacity
    that decode keeps; at ``moe_group_size=1`` no choice is dropped and both
    route alike, so the MoE check runs there (as
    ``tests/test_torch_families.py`` does)."""

    return dataclasses.replace(cfg, moe_group_size=1) if cfg.family == "moe" else cfg


def decode_vs_forward(dev, cfg, params, n: int, extra: dict):
    """prefill(tokens[:-1]) + one decode step vs prefill(tokens), at batch 4:
    the two last-position logits."""

    model = get_model(decode_config(cfg), dev)
    g = torch.Generator(device=dev).manual_seed(7)
    seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, n), generator=g, device=dev)
    full, _ = model.prefill(params, dict(extra, tokens=seq))
    _, cache = model.prefill(params, dict(extra, tokens=seq[:, :-1]))
    step, _ = model.decode_step(params, pad_cache(cache, 1), seq[:, -1:], n - 1)
    return step[:, 0], full[:, 0]


def phase_serve(dev: torch.device, arch: str) -> dict:
    """The model main path at full width (and depth, but where ``SERVE_DEPTH``
    cuts it), then its checks."""

    cfg = serve_config(arch)
    prompt = PROMPT_OF.get(arch, SERVE_PROMPT)
    name, expected = prefill_launches(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the peak below is this arch's own
    model = get_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init_params(SERVE_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    extra = frontend_inputs(cfg, SERVE_BATCH, SERVE_SEED + 2, dev)
    kw = dict(batch=SERVE_BATCH, prompt_len=prompt, gen=SERVE_GEN, seed=SERVE_SEED,
              device=dev, params=params, **extra)

    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    res = serve(cfg, **kw)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_ops.launches["flash_attention"],
                "ssm_scan": ssm_ops.launches["ssm_scan"]}
    if launches[name] < expected:
        fail(f"{arch}: {name} launched {launches[name]} times on the main path, "
             f"expected >= {expected} (one a layer, or a shared-attention group, of the "
             "prefill)")
    toks = res["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN):
        fail(f"{arch}: generated {tuple(toks.shape)} tokens")
    # the padded vocabulary's rows (internvl2: 92,553 -> 92,672; whisper: 51,865
    # -> 51,968) are random weights that can win a greedy argmax, unmasked in
    # either package, so tokens are gated at padded_vocab, as serve gates them
    if not bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()):
        fail(f"{arch}: generated token ids outside the padded vocabulary")
    in_padding = int((toks >= cfg.vocab_size).sum())
    if not bool(torch.isfinite(res["prefill_logits"]).all()):
        fail(f"{arch}: non-finite prefill logits")
    log(f"[serve] {arch}: launches on the main path {json.dumps(launches)}; "
        f"first call prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
        f"{res['decode_s'] * 1e3:.1f} ms; seq0 {toks[0, :12].tolist()}; "
        f"{in_padding} of {toks.numel()} tokens in the vocabulary's padding")

    warm = serve(cfg, **kw)
    if not torch.equal(warm["tokens"], toks):
        fail(f"{arch}: a second serve call generated other tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # device busy share of one prefill and of one decode step, and the
    # prefill's largest device ops (which show whether the profiler sees
    # the port's own kernels, whose libraries link the CUDA runtime
    # statically)
    with torch.inference_mode():
        gp = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt), generator=gp,
                                device=dev)
        nb = PROFILE_BATCH.get(arch, SERVE_BATCH)
        profile_batch = {"tokens": prompts[:nb], **{k: v[:nb] for k, v in extra.items()}}
        pre_wall, pre_busy, pre_ops = device_time(lambda: model.prefill(params, profile_batch))
        top = top_device_ops(lambda: model.prefill(params, profile_batch))
        logits, cache = model.prefill(params, profile_batch)
        cache = pad_cache(cache, 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        model.decode_step(params, cache, tok, prompt)
        dec_wall, dec_busy, dec_ops = device_time(
            lambda: model.decode_step(params, cache, tok, prompt), iters=3)
        del cache, logits
    log(f"[serve] {arch}: profiled at batch {nb}: prefill "
        f"{pre_wall * 1e3:.1f} ms, device busy {pre_busy * 1e3:.1f} ms ({pre_busy / pre_wall:.1%}) "
        f"over {pre_ops} ops; decode step {dec_wall * 1e3 / 3:.1f} ms, device busy "
        f"{dec_busy * 1e3 / 3:.2f} ms ({dec_busy / dec_wall:.1%}) over {dec_ops // 3} ops a step")
    log(f"[serve] {arch}: prefill's largest device ops (ms, calls): {json.dumps(top)}")
    scan_err = (scan_on_model_inputs(model, params, prompts, cfg.n_layers)
                if name == "ssm_scan" else None)

    with torch.inference_mode():
        n = forward_len(cfg, prompt)
        step, full = decode_vs_forward(dev, cfg, params, n, extra)
        dec_err = float((step.float() - full.float()).abs().max())
        if arch in BF16_GATED:
            _held(f"{arch} decode vs forward", step, full, BF16_TOL, BF16_TOL)
        dec_agree = _agreement(step, full)
        if dec_agree < 0.5:
            fail(f"{arch}: decode and forward argmax agree on {dec_agree:.0%} of rows")
        del step, full

        # the same prefill through the layer's own paths ("torch")
        plain = get_model(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"),
                          dev)
        hk, _ = model.forward(params, prompts, **extra)
        lk = model_layers.lm_logits(cfg, params, hk[:, -32:]).float()
        del hk
        ht, _ = plain.forward(params, prompts, **extra)
        lt = model_layers.lm_logits(cfg, params, ht[:, -32:]).float()
        del ht
        if not torch.equal(lk[:, -1], res["prefill_logits"].to(dev)):
            fail(f"{arch}: forward's last logits differ from serve's prefill")
        path_err = float((lt[:, -1] - lk[:, -1]).abs().max())
        if arch in BF16_GATED:
            _held(f"{arch} torch vs kernel prefill", lt[:, -1], lk[:, -1], BF16_TOL, BF16_TOL)
        path_agree = _agreement(lt.reshape(-1, lt.shape[-1]), lk.reshape(-1, lk.shape[-1]))
        if path_agree < 0.5:
            fail(f"{arch}: torch and kernel prefill argmax agree on {path_agree:.0%} of rows")
    out = {
        "model": arch, "layers": cfg.n_layers, "parameters": n_params,
        "batch": SERVE_BATCH, "prompt": prompt, "gen": SERVE_GEN,
        "launches": launches, "expected_launches_per_prefill": expected,
        "tokens_in_vocab_padding": in_padding,
        "prefill_ms": warm["prefill_s"] * 1e3,
        "decode_ms_per_token": warm["decode_s"] * 1e3 / warm["decode_steps"],
        "decode_tokens_per_s": warm["decode_tokens_per_s"],
        "prefill_tokens_per_s": SERVE_BATCH * prompt / warm["prefill_s"],
        "first_call_prefill_ms": res["prefill_s"] * 1e3,
        "peak_gib": peak,
        "decode_vs_forward_max_abs_err": dec_err, "decode_vs_forward_argmax": dec_agree,
        "decode_vs_forward_len": n,
        "decode_vs_forward_moe_group_size": decode_config(cfg).moe_group_size
        if cfg.family == "moe" else None,
        "torch_vs_kernel_max_abs_err": path_err, "torch_vs_kernel_argmax": path_agree,
        "profiled_prefill_ms": pre_wall * 1e3, "prefill_busy_ms": pre_busy * 1e3,
        "prefill_busy_share": pre_busy / pre_wall,
        "prefill_device_ops": pre_ops, "profiled_decode_step_ms": dec_wall * 1e3 / 3,
        "decode_step_busy_ms": dec_busy * 1e3 / 3, "decode_step_busy_share": dec_busy / dec_wall,
        "decode_step_device_ops": dec_ops // 3,
        "prefill_top_device_ops": top, "profiled_batch": nb,
        "scan_on_model_inputs_max_abs_err": scan_err,
    }
    log(f"[serve] {arch}: prefill {out['prefill_ms']:.2f} ms, decode "
        f"{out['decode_ms_per_token']:.2f} ms a token, peak {peak:.2f} GiB, device busy "
        f"{out['prefill_busy_share']:.1%} of a prefill and {out['decode_step_busy_share']:.1%} "
        "of a decode step")
    log(f"[serve] {json.dumps(out)}")
    del params, model
    torch.cuda.empty_cache()
    return out


def scan_on_model_inputs(model, params, prompts: torch.Tensor, n_layers: int) -> dict:
    """``ssm_scan`` against its plain version on the arguments the model
    gives it in one prefill at the serve shape (delta = softplus of a
    projection, A = -exp(A_log)), at the first and the last layer, with x
    in bf16 and in f32.  The random weights make x, B and C small, which
    would leave the absolute tolerance nothing to test; y is linear in
    each, so each is rescaled to unit RMS first, the scale of the other
    scan cases.  Returns the largest |error| of y for each x dtype."""

    kernel_op, captured = model_layers.ssm_scan_op, []

    def capture(*args, **kw):
        if len(captured) in (0, n_layers - 1):
            captured.append((args, kw))
        else:
            captured.append(None)
        return kernel_op(*args, **kw)

    model_layers.ssm_scan_op = capture
    try:
        with torch.inference_mode():
            model.prefill(params, {"tokens": prompts})
    finally:
        model_layers.ssm_scan_op = kernel_op
    def unit_rms(t):
        t = t.float()
        return t / t.square().mean().sqrt()

    worst = {"bfloat16": 0.0, "float32": 0.0}
    for layer in (0, n_layers - 1):
        (delta, B, C, x, A), kw = captured[layer]
        rms = [float(t.float().square().mean().sqrt()) for t in (x, B, C)]
        log(f"[serve] scan inputs of layer {layer}: delta in [{float(delta.min()):.3g}, "
            f"{float(delta.max()):.3g}], mean {float(delta.mean()):.3g}; A in "
            f"[{float(A.min()):.3g}, {float(A.max()):.3g}]; RMS of x, B, C "
            f"{rms[0]:.3g}, {rms[1]:.3g}, {rms[2]:.3g}")
        B, C, x = unit_rms(B), unit_rms(C), unit_rms(x)
        for xdtype in (torch.bfloat16, torch.float32):
            args = (delta, B, C, x.to(xdtype), A)
            y, h = ssm_ops.ssm_scan_op(*args, **kw)
            yr, hr = ssm_ref.ssm_scan_ref(*args)
            label = f"ssm_scan on layer {layer}'s inputs {tuple(delta.shape)} x {xdtype}"
            key = str(xdtype).removeprefix("torch.")
            worst[key] = max(worst[key], _held(label + " y", y, yr, SSM_TOL[xdtype],
                                               SSM_TOL[xdtype]))
            _held(label + " h_last", h, hr, 1e-3, 1e-3)
    log(f"[serve] ssm_scan on the model's own delta and A (layers 0 and {n_layers - 1}; x, B, "
        f"C at unit RMS) within 1e-4 (x f32) / 3e-2 (x bf16): max |y err| {json.dumps(worst)}")
    return worst


def top_device_ops(fn, k: int = 8) -> list:
    """The ``k`` device ops with the most device time in one call of
    ``fn``: [name, ms, calls]."""

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_ops(prof)[:k]


def phase_f32_paths(dev: torch.device, arch: str) -> dict:
    """At full width in f32 (TF32 off), at full depth where it fits
    (``F32_DEPTH``): decode against forward (prefill(tokens[:-1]) + one
    decode step vs prefill(tokens)), and the ``"torch"`` prefill against
    the kernel prefill.  The MoE runs both at ``moe_group_size=1``
    (``decode_config``)."""

    cfg = dataclasses.replace(serve_config(arch), dtype="float32")
    if arch in F32_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=F32_DEPTH[arch])
    cfg = decode_config(cfg)
    model = get_model(cfg, dev)
    plain = get_model(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"), dev)
    params = model.init_params(SERVE_SEED)
    n = forward_len(cfg, PROMPT_OF.get(arch, SERVE_PROMPT))
    extra = frontend_inputs(cfg, SERVE_BATCH, SERVE_SEED + 2, dev)
    with torch.inference_mode():
        step, full = decode_vs_forward(dev, cfg, params, n, extra)
        g = torch.Generator(device=dev).manual_seed(7)
        seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, n), generator=g, device=dev)
        torch_full, _ = plain.prefill(params, dict(extra, tokens=seq))
    tol = (F32_TOL["atol"], F32_TOL["rtol"])
    out = {"tokens": n, "layers": cfg.n_layers,
           "decode_vs_forward": _held(f"{arch} decode vs forward (f32)", step, full, *tol),
           "torch_vs_kernel": _held(f"{arch} torch vs kernel prefill (f32)", torch_full[:, 0],
                                    full, *tol)}
    log(f"[f32] {arch}: full width, {cfg.n_layers} layers, {n} tokens: max |logit diff| "
        f"decode vs forward {out['decode_vs_forward']:.3g}, torch vs kernel prefill "
        f"{out['torch_vs_kernel']:.3g} (atol {tol[0]}, rtol {tol[1]})")
    del params, model, plain
    torch.cuda.empty_cache()
    return out


def phase_card_vs_cpu(dev: torch.device, arch: str) -> float:
    """Full width, depth 2 (the hybrid: one group of ``shared_attn_every``
    Mamba-2 layers and its shared attention; whisper-tiny: all 4 + 4
    layers; grok-1-314b: 1, ``CARD_VS_CPU_DEPTH``), f32, TF32 off: one prompt of 256 tokens (the VLM: 512, its
    first 256 positions patches) through the same weights on the card
    (kernels) and on the CPU (plain versions).  The parameters move to the
    CPU after the card's prefill, so no second copy is held.  For the MoE,
    the share of (token, choice) routes (expert, kept) that differ between
    the two is reported."""

    cfg = get_config(arch)
    depth = {"hybrid": cfg.shared_attn_every, "encdec": cfg.n_layers}.get(
        cfg.family, CARD_VS_CPU_DEPTH.get(arch, 2))
    cfg = dataclasses.replace(cfg, n_layers=depth, dtype="float32")
    model = get_model(cfg, dev)
    params = model.init_params(SERVE_SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, 256 + cfg.n_patches),
                         generator=torch.Generator().manual_seed(3))
    extra = {k: v.cpu() for k, v in frontend_inputs(cfg, 1, SERVE_SEED + 3, dev).items()}
    card_routes, cpu_routes = [], []
    with torch.inference_mode():
        with _RouteRecorder(card_routes, dev):
            card, _ = model.prefill(params, {"tokens": toks.to(dev),
                                             **{k: v.to(dev) for k, v in extra.items()}})
        card = card.cpu()
        params.to("cpu")
        torch.cuda.empty_cache()
        with _RouteRecorder(cpu_routes, "cpu"):
            cpu, _ = get_model(cfg, "cpu").prefill(params, {"tokens": toks, **extra})
    err = _held(f"{arch} card vs cpu (f32, depth {depth})", card, cpu, F32_TOL["atol"],
                F32_TOL["rtol"])
    moe = ""
    if card_routes:
        differ = sum(int(((a[0] != b[0]) | (a[1] != b[1])).sum())
                     for a, b in zip(card_routes, cpu_routes, strict=True))
        total = sum(a[0].numel() for a in card_routes)
        moe = f"; {differ} of {total} (token, choice) routes differ ({differ / total:.4%})"
    log(f"[card-vs-cpu] {arch}: full width, {depth} layers, {toks.shape[1]} tokens, f32: max "
        f"|logit diff| {err:.3g} (atol {F32_TOL['atol']}, rtol {F32_TOL['rtol']}){moe}")
    del params, model
    return err


def raw_fa_launch(q, k, v, causal: bool = True):
    """The attention kernel's C entry point with no wrapper around it, on
    the model's (B, S, H, hd) layout."""

    lib = fa_kernel.load()
    o = torch.empty_like(q)
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            1 if q.dtype == torch.bfloat16 else 0, q.shape[0], q.shape[2], k.shape[2],
            q.shape[1], k.shape[1], q.shape[3], 1.0 / math.sqrt(q.shape[3]), int(causal),
            *strides, torch.cuda.current_stream().cuda_stream)
    if lib.flash_attention_launch(*args) != 0:
        fail("raw flash_attention launch failed")

    def launch():
        lib.flash_attention_launch(*args)

    launch.buffers = (q, k, v, o)
    return launch


def raw_ssm_launch(delta, B, C, x, A):
    lib = ssm_kernel.load()
    b, s, di = delta.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    h = torch.empty(b, di, n, dtype=torch.float32, device=x.device)
    args = (delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(), A.data_ptr(),
            y.data_ptr(), h.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0, b, s, di, n,
            torch.cuda.current_stream().cuda_stream)
    if lib.ssm_scan_launch(*args) != 0:
        fail("raw ssm_scan launch failed")

    def launch():
        lib.ssm_scan_launch(*args)

    launch.buffers = (delta, B, C, x, A, y, h)
    return launch


def attention_row(dev: torch.device, name: str, shape: tuple, of: str, worst: dict,
                  launches: dict) -> dict:
    """The attention kernel (``name``: the row of its instance) at a prefill
    shape ``(b, h, kv, sq, sk, hd, causal)`` (the attention of ``of``) in
    bf16, beside its bound, its plain version and
    ``scaled_dot_product_attention``."""

    b, h, kv, s, sk, hd, causal = shape
    q, k, v = fa_inputs(dev, b, h, kv, s, sk, hd, torch.bfloat16, seed=5, bshd=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # causal: the pairs qpos >= kpos (sq == sk)
    flops = 4 * b * h * (s * (s + 1) // 2 if causal else s * sk) * hd
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(raw_fa_launch(q, k, v, causal), iters=20, warmup=3)
    f32_ms = cuda_ms(raw_fa_launch(q.float(), k.float(), v.float(), causal), iters=5, warmup=1)
    return {
        "name": name, "route": "cuda", "source": MODEL_SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": launches.get(name, 0),
        "max_abs_err": worst[name],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: fa_ref.flash_attention_ref(qt, kt, vt, causal=causal),
                            iters=5, warmup=1),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20, warmup=3),
        "call_ms": cuda_ms(lambda: fa_ops.flash_attention_bshd(q, k, v, causal=causal),
                           iters=20, warmup=3),
        "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bfloat16",
                  "causal": causal, "layout": "bshd", "prefill_of": of},
        "flops": flops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        # the f32 path (CUDA cores, no TF32) on the same inputs in f32, against
        # the 67 TFLOP/s f32 rate
        "f32_ms": f32_ms, "f32_achieved_tflops": flops / (f32_ms * 1e-3) / 1e12,
        "f32_ops_ms": flops / F32_FLOPS * 1e3,
        "library_call": f"F.scaled_dot_product_attention(q, k, v, is_causal={causal}, "
                        "enable_gqa=True): a yardstick the port never calls",
    }


def model_kernel_timings(dev: torch.device, worst: dict, launches: dict,
                         sm_clock_hz: float) -> list[dict]:
    """The model kernels at the serve slice's shapes, in bf16: attention at
    qwen3-1.7b's prefill (hd 128), at stablelm-3b's (hd 80, the shape of
    zamba2-2.7b's shared block too) and at whisper-tiny's encoder (hd 64,
    non-causal over 1,500 frames), the scan at falcon-mamba-7b's.
    ``ms`` from CUDA events over back-to-back raw launches, ``plain_ms``
    and ``library_ms`` from CUDA events over calls."""

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    def prefill_shape(arch):
        b, h, kv, s, hd = FA_SERVE[arch]
        return (b, h, kv, s, s, hd, True)

    out = [attention_row(dev, "flash_attention", prefill_shape("qwen3-1.7b"), "qwen3-1.7b",
                         worst, launches),
           attention_row(dev, "flash_attention_hd80", prefill_shape("stablelm-3b"),
                         "stablelm-3b", worst, launches),
           attention_row(dev, "flash_attention_hd64", WHISPER_ENCODER, "whisper-tiny's encoder",
                         worst, launches)]

    b, s, di, n, _, _ = SSM_CASES[-1]
    args = ssm_inputs(dev, b, s, di, n, torch.bfloat16, seed=6)
    exps = b * s * di * n
    nbytes = (b * s * di * (4 + 2 + 2)  # delta f32 and x in, y out (bf16)
              + 2 * b * s * n * 4 + di * n * 4 + b * di * n * 4)  # B, C, A in; h_last out
    t_exp = exps / (SFU_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    t_f32 = 7 * exps / F32_FLOPS * 1e3  # d*A, d*B, *x, a*h+bx (2), h*C, the sum over n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(raw_ssm_launch(*args), iters=20, warmup=3)
    out.append({
        "name": "ssm_scan", "route": "cuda", "source": MODEL_SOURCES["ssm_scan"],
        "replaces": REPLACES["ssm_scan"], "launches": launches["ssm_scan"],
        "max_abs_err": worst["ssm_scan"],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: ssm_ref.ssm_scan_ref(*args), iters=2, warmup=1),
        "bound_ms": max(t_exp, t_f32, t_bytes),
        "bound_by": "operations" if max(t_exp, t_f32) > t_bytes else "bytes",
        "library_ms": None,
        "call_ms": cuda_ms(lambda: ssm_ops.ssm_scan_op(*args, block_d=512, chunk=256),
                           iters=20, warmup=3),
        "shape": {"delta": [b, s, di], "N": n, "x_dtype": "bfloat16"},
        "exponentials": exps, "bytes": nbytes, "exp_ms": t_exp, "f32_ops_ms": t_f32,
        "bytes_ms": t_bytes, "sm_clock_mhz": sm_clock_hz / 1e6, "sms": sms,
        "library_call": "none: no single PyTorch call computes the selective scan",
    })
    return out



# the training slice: (arch, layers kept (None: all), steps, save_async after
# this step, batch, gradient compression); batch x 2048 tokens (whisper-tiny:
# its 448-token text context) from ShardedLoader(seed=0), AdamW at lr 3e-4
# with linear_warmup_cosine(steps // 3, steps).  Weights, gradients and
# AdamW's f32 moments take 12 bytes a parameter.  moonshot and internvl2 run
# at depth 2: at 8 and 10 layers they fit (64.2 and 64.9 GiB), but their
# 10 GB checkpoints took 100 s and 77 s of the script's time, and at depth 4
# their phases 49 s and 41 s, most of it the 5.9 and 5.4 GB saves and their
# restores (cut to 2 for the 1,200 s limit); zamba2-2.7b
# runs at batch 1 (a batch-4 prefill alone takes 13.7 s) with compression
# on, whose rows are its groups of six layers, at 36 of its 54 layers (six
# groups; whole, its phase took 79 s, cut for the mesh and dry-run phases'
# time); falcon-mamba-7b at depth 4 (8 until the mesh and dry-run phases took
# the ssm, hybrid and encoder-decoder families, for their time).
TRAIN_RUNS = (("falcon-mamba-7b", 4, 3, 2, 4, False), ("zamba2-2.7b", 36, 2, 1, 1, True),
              ("whisper-tiny", None, 3, 2, 4, False), ("qwen3-1.7b", None, 6, 3, 4, False),
              ("moonshot-v1-16b-a3b", 2, 3, 2, 4, False), ("internvl2-26b", 2, 3, 2, 4, False))
TRAIN_SEQ_OF = {"whisper-tiny": 448}
TRAIN_PROFILED_STEP = 1  # after the first step's warm-up, before any save
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2048, 3e-4
# card against CPU: 3 steps at lr 3e-4.  The first step's loss and
# grad_norm differ only by summation order (rtol 1e-5).  Adam divides each
# gradient by its own magnitude, so an element whose gradient is at the two
# devices' rounding level can move by up to 2 lr a step either way: all
# elements are held to that, all but 1e-4 of them to atol 1e-5 / rtol
# 1e-4, and the later steps' loss and grad_norm, computed on those
# parameters, to rtol 1e-3.
TRAIN_F32_TOL = {"atol": 1e-5, "rtol": 1e-4, "outlier_share": 1e-4,
                 "first_step_rtol": 1e-5, "later_steps_rtol": 1e-3}
# card against CPU at full width, f32: (arch, layers kept, tokens of the one
# sequence, steps).  The CPU half sets the time: at depth 2 and 3 steps
# moonshot's took 77 s and internvl2's 83 s (their embeddings and heads
# alone are 0.67 and 1.14 B parameters), and zamba2's six Mamba-2 layers
# over 256 tokens 158 s, so the MoE and the VLM run at depth 1 (the VLM's
# 288 tokens are its 256 patches and 32 text tokens), zamba2's one group of
# six over 32 tokens (64 until the mesh and dry-run phases needed the
# time); qwen3 2 steps and whisper 3 (the later steps' gate), the MoE, the
# VLM and zamba2 1.  The CPU halves (148 s of the script's time when they
# ran after the card halves, 2 steps each) run on a worker thread at the
# lowest priority beside TRAIN_RUNS and phase_fused_proj (the training CLI
# on another), on CPU_HALF_THREADS of the host's 8 cores; the card halves
# and the comparisons follow.  Beside them the checkpoint snapshots, saves
# and restores of TRAIN_RUNS, which move host memory, took up to twice as
# long (the CPU halves' AdamW is bound by the same memory), so TRAIN_RUNS
# starts with the runs whose steps hold the card longest
TRAIN_VS_CPU = (("qwen3-1.7b", 2, 256, 2), ("moonshot-v1-16b-a3b", 1, 256, 1),
                ("internvl2-26b", 1, 288, 1), ("whisper-tiny", None, 256, 3),
                ("zamba2-2.7b", 6, 32, 1))
CPU_HALF_THREADS = 6


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _leaves(tree: dict, prefix: str = "") -> list:
    """(path, leaf) of a nested dict."""

    out = []
    for k, v in tree.items():
        out += _leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def _same_params(label: str, want, got) -> None:
    for (name, a), b in zip(want.named_parameters(), got.parameters()):
        if a.dtype != b.dtype or not torch.equal(_bits(a.detach()), _bits(b.detach())):
            fail(f"{label}: {name} differs")


def _reference_layout(cfg) -> dict:
    """Manifest path -> (shape, dtype) of the reference's tree of ``cfg``:
    every stack (``layers``; the hybrid's ``mamba`` on (G, E) and its
    ``shared`` block; the encoder-decoder's ``encoder`` and ``decoder``)
    under its own name, the scan dynamics in f32."""

    f32 = {"ssm": ("A_log",), "hybrid": ("A_log", "dt_bias")}.get(cfg.family, ())
    return {path: (tuple(shape), "float32" if path.rsplit("/", 1)[-1] in f32 else cfg.dtype)
            for path, shape in _leaves(get_model(cfg, "meta").param_specs(), "params/")}


def train_config(arch: str, layers) -> object:
    """``arch``'s published config on the torch paths, its depth cut to
    ``layers`` where given."""

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch")


def train_batch(dev, cfg, loader: ShardedLoader, step: int, batch: int) -> dict:
    """The loader's tokens and labels of ``step``, and the VLM's or the
    encoder-decoder's seeded frontend inputs."""

    out = {k: torch.from_numpy(v).to(dev) for k, v in loader.get(step).items()}
    return dict(out, **frontend_inputs(cfg, batch, SERVE_SEED + 10 + step, dev))


def phase_train(dev: torch.device, arch: str, layers, steps: int, async_after: int,
                batch_n: int, compress: bool) -> dict:
    """``make_train_step`` at full width (depth cut to ``layers``), bf16,
    ``remat="block"``, torch impls, batch ``batch_n``, gradient compression
    if ``compress``: ``steps`` steps, ``save_async`` after step
    ``async_after`` and ``save_blocking`` at the end through
    ``Checkpointer`` -> ``TieredCheckpointStore``; then the restored
    parameters are held bit-equal to the live ones, the manifest to the
    reference's layout, the async checkpoint to a copy taken at its step,
    and the restored parameters' kernel prefill (``batch_n`` prompts) to the
    live ones' bit for bit and to the torch prefill within the serve
    tolerance (argmax agreement for zamba2's 36 layers, as in serve)."""

    cfg = train_config(arch, layers)
    if cfg.remat != "block" or cfg.dtype != "bfloat16":
        fail(f"{arch}: the training slice runs bf16 with remat='block'")
    seq = TRAIN_SEQ_OF.get(arch, TRAIN_SEQ)
    name, per_prefill = prefill_launches(cfg)
    model = get_model(cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    params = model.init_params(SERVE_SEED)
    n_params = sum(p.numel() for p in params.parameters())
    save_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    opt_state = init_state(dict(params.named_parameters()))
    step_fn = make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, schedule=linear_warmup_cosine(steps // 3, steps)),
        CompressionConfig(enabled=compress))
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch_n, seed=0), host_id=0)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        log(f"[train] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B parameters in bf16 ({save_bytes / 1e9:.2f} GB a save); "
            f"batch {batch_n} x {seq}, compression {'on' if compress else 'off'}; "
            f"{free / 1e9:.1f} GB free under {root}")
        if free < 3 * save_bytes:
            fail(f"{arch}: {free / 1e9:.1f} GB free, a save needs {save_bytes / 1e9:.2f} GB")
        ck = Checkpointer(TieredCheckpointStore(root))
        records, snapshot_s, at_async, profile = [], {}, None, None
        for step in range(steps):
            batch = train_batch(dev, cfg, loader, step, batch_n)
            torch.cuda.synchronize()
            in_flight = ck.saves_started > ck.saves_completed
            profiled = step == TRAIN_PROFILED_STEP and steps > 2
            prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            with prof:
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, batch)
                loss, gnorm, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            if profiled:
                ops = device_ops(prof)
                profile = {"step": step, "wall_ms": ms,
                           "busy_ms": sum(r[1] for r in ops), "device_ops": sum(r[2] for r in ops),
                           "top_device_ops": ops[:10]}
            records.append({"step": step, "ms": ms, "loss": loss, "grad_norm": gnorm, "lr": lr,
                            "save_in_flight": in_flight,
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            log(f"[train] {arch}: step {step} loss {loss:.4f} grad_norm {gnorm:.4f} "
                f"lr {lr:.3g} {ms:.1f} ms{' (a save in flight)' if in_flight else ''}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                fail(f"{arch}: non-finite loss or grad_norm at step {step}")
            if step + 1 == async_after:
                t0 = time.perf_counter()
                tree = tree_from_params(params)
                # a host copy of the parameters at this step, to hold the
                # async checkpoint against
                at_async = {path: t.to("cpu", copy=True) for path, t in _leaves(tree)}
                ck.save_async(step + 1, {"params": tree})
                del tree
                snapshot_s["async"] = time.perf_counter() - t0
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        ck.save_blocking(steps, {"params": tree_from_params(params)})
        snapshot_s["blocking_total"] = time.perf_counter() - t0
        ck.close()
        del opt_state
        torch.cuda.empty_cache()

        store = TieredCheckpointStore(root)
        bb, layout = {}, _reference_layout(cfg)
        for s in (async_after, steps):
            with open(store.manifest_path(s)) as f:
                man = json.load(f)
            bb[s] = man["bb_stats"]
            got = {leaf["path"]: (tuple(leaf["shape"]), leaf["dtype"]) for leaf in man["leaves"]}
            if got != layout:
                fail(f"{arch}: manifest of step {s} is not the reference layout")
        t0 = time.perf_counter()
        step_back, tree = Checkpointer(store).restore_latest(
            like={"params": tree_from_params(params)})
        restored = params_from_jax(cfg, tree["params"], device=dev)
        restore_s = time.perf_counter() - t0
        if step_back != steps:
            fail(f"{arch}: restored step {step_back}, expected {steps}")
        _same_params(f"{arch} restored vs live", params, restored)
        early = dict(_leaves(store.load(async_after)["params"]))
        for k, want in at_async.items():
            got = early[k]
            got = got if isinstance(got, torch.Tensor) else torch.from_numpy(np.array(got))
            if not torch.equal(_bits(got.cpu()), _bits(want)):
                fail(f"{arch}: the async checkpoint of step {async_after} differs from "
                     f"the parameters at that step ({k})")
        del tree, at_async, early
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the restored checkpoint served: kernel prefill of the restored and the
    # live parameters bit-equal, the torch prefill within the serve tolerance
    # (the archs gated in serve, and runs cut to under half their depth:
    # falcon-mamba-7b at 4 of 64 layers) or agreeing on the argmax
    # (zamba2-2.7b at 36 of 54 layers reached 0.117 in bf16, as at 54)
    kernel_model = get_model(dataclasses.replace(cfg, attention_impl="kernel",
                                                 ssm_impl="kernel"), dev)
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    prompt = PROMPT_OF.get(arch, SERVE_PROMPT)
    inputs = dict(frontend_inputs(cfg, batch_n, SERVE_SEED + 2, dev), tokens=torch.randint(
        0, cfg.vocab_size, (batch_n, prompt), generator=g, device=dev))
    with torch.inference_mode():
        live, _ = kernel_model.prefill(params, inputs)
        back, _ = kernel_model.prefill(restored, inputs)
        plain, _ = model.prefill(restored, inputs)
    launches = {"flash_attention": fa_ops.launches["flash_attention"],
                "ssm_scan": ssm_ops.launches["ssm_scan"]}
    if launches[name] != 2 * per_prefill:
        fail(f"{arch}: {name} launched {launches[name]} times serving the restored "
             f"checkpoint, expected {2 * per_prefill} (two kernel prefills)")
    if not torch.equal(live, back):
        fail(f"{arch}: the restored parameters' kernel prefill differs from the live ones'")
    if arch in BF16_GATED or 2 * cfg.n_layers < get_config(arch).n_layers:
        serve_err = _held(f"{arch} restored: torch vs kernel prefill", plain[:, -1],
                          back[:, -1], BF16_TOL, BF16_TOL)
    else:
        serve_err = float((plain[:, -1].float() - back[:, -1].float()).abs().max())
        if _agreement(plain[:, -1], back[:, -1]) < 0.5:
            fail(f"{arch} restored: torch and kernel prefill argmax agree on under half the rows")
    # steady: past the first step, no save in flight, and not under the
    # profiler where another step is
    steady = [r["ms"] for r in records[1:] if not r["save_in_flight"]]
    if len(steady) > 1:
        steady = [r["ms"] for r in records[1:]
                  if not r["save_in_flight"] and r["step"] != TRAIN_PROFILED_STEP]
    during = [r["ms"] for r in records if r["save_in_flight"]]
    tokens = batch_n * seq
    out = {
        "model": arch, "layers": cfg.n_layers, "parameters": n_params, "steps": steps,
        "batch": batch_n, "seq": seq, "compression": compress, "records": records,
        "first_step_ms": records[0]["ms"],
        "step_ms": sum(steady) / len(steady) if steady else None,
        "step_ms_save_in_flight": sum(during) / len(during) if during else None,
        "tokens_per_s": tokens / (sum(steady) / len(steady) / 1e3) if steady else None,
        "peak_gib": peak_train, "save_bytes": save_bytes,
        "save_seconds": ck.save_seconds, "snapshot_seconds": snapshot_s,
        "restore_seconds": restore_s, "bb_stats": bb, "launches": launches,
        "profiled_step": profile,
        "restored_prompts": [batch_n, prompt],
        "restored_torch_vs_kernel_max_abs_err": serve_err,
    }
    log(f"[train] {json.dumps(out)}")
    del params, restored, model, kernel_model, live, back, plain
    torch.cuda.empty_cache()
    return out


class _RouteRecorder:
    """While entered, ``moe_routing``'s (expert, kept) choices of the calls
    made on ``device``'s type, appended to ``routes``; other calls pass
    through unrecorded (the CPU halves of ``TRAIN_VS_CPU`` run beside the
    card's train phases, which route too; the card's backward pass, which
    recomputes the forward, runs on autograd's own thread)."""

    def __init__(self, routes: list, device):
        self.routes, self.device = routes, torch.device(device).type

    def __enter__(self):
        self.routing = routing = model_layers.moe_routing

        def record(*args, **kw):
            out = routing(*args, **kw)
            _, idx, slot, cap = out
            if idx.device.type == self.device:
                self.routes.append((idx.cpu(), (slot < cap).cpu()))
            return out

        model_layers.moe_routing = record
        return self

    def __exit__(self, *exc):
        model_layers.moe_routing = self.routing


def train_vs_cpu_case(dev: torch.device, arch: str, layers, seq: int, steps: int) -> dict:
    """One ``TRAIN_VS_CPU`` comparison's inputs: ``arch`` at full width,
    depth ``layers`` (None: whole), f32, its weights drawn on the card and
    held on the CPU, and ``steps`` batches of 1 x ``seq`` tokens."""

    cfg = dataclasses.replace(train_config(arch, layers), dtype="float32")
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=1, seed=0), host_id=0)
    return {"arch": arch, "cfg": cfg, "seq": seq, "steps": steps,
            "params": get_model(cfg, dev).init_params(SERVE_SEED).to("cpu"),
            "batches": [train_batch("cpu", cfg, loader, step, 1) for step in range(steps)]}


def _train_f32(case: dict, where) -> dict:
    """``case``'s steps on ``where`` from a copy of its weights: the
    parameters after them, each step's (loss, grad_norm), the seconds taken
    and the MoE's routing choices."""

    opt = AdamWConfig(lr=TRAIN_LR, schedule=linear_warmup_cosine(1, 3))
    routes: list = []
    t0 = time.perf_counter()
    with _RouteRecorder(routes, where):
        params = copy.deepcopy(case["params"]).to(where)
        state = init_state(dict(params.named_parameters()))
        step_fn = make_train_step(get_model(case["cfg"], where), opt)
        metrics = []
        for b in case["batches"]:
            params, state, m = step_fn(params, state, {k: v.to(where) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"params": params, "metrics": metrics, "seconds": time.perf_counter() - t0,
            "routes": routes}


def train_cpu_halves(cases: list) -> list:
    """The CPU half of every ``TRAIN_VS_CPU`` case, one after another, on
    ``CPU_HALF_THREADS`` of the host's cores: run on a worker thread beside
    the card's train phases, whose steps keep the card busy and leave the
    host's cores mostly idle.  The thread (and the threads its CPU ops
    start) runs at the lowest priority, so the host work of the card's
    phases goes first."""

    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, CPU_HALF_THREADS))
    try:
        out = []
        return [_train_f32(case, "cpu") for case in cases]
    finally:
        torch.set_num_threads(threads)


def phase_train_card_vs_cpu(dev: torch.device, case: dict, cpu_run: dict) -> dict:
    """``case``'s (:func:`train_vs_cpu_case`) steps on the card, held on the
    card against ``cpu_run``, the same steps on the CPU from the same
    weights and batches (:func:`train_cpu_halves`).  For the MoE, the share
    of (token, choice) routes (expert, kept) that differ between the two
    runs' calls is reported, as in ``phase_card_vs_cpu``."""

    arch, cfg, seq, steps = case["arch"], case["cfg"], case["seq"], case["steps"]
    card_run = _train_f32(case, dev)
    case["params"] = None
    p_cpu, m_cpu, t_cpu = cpu_run["params"], cpu_run["metrics"], cpu_run["seconds"]
    p_card, m_card, t_card = card_run["params"], card_run["metrics"], card_run["seconds"]
    metric_err = [max(abs(a - b) / abs(a) for a, b in zip(ra, rb))
                  for ra, rb in zip(m_cpu, m_card)]
    for step, err in enumerate(metric_err):
        tol = TRAIN_F32_TOL["first_step_rtol" if step == 0 else "later_steps_rtol"]
        if err > tol:
            fail(f"train card vs cpu ({arch}): loss/grad_norm of step {step} differ by "
                 f"{err:.3g} relative (rtol {tol})")
    worst, outliers, total = 0.0, 0, 0
    bound = 2 * TRAIN_LR * steps
    for (name, a), b in zip(p_cpu.named_parameters(), p_card.parameters()):
        a, b = a.detach().to(dev), b.detach()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        outliers += int((diff > TRAIN_F32_TOL["atol"] + TRAIN_F32_TOL["rtol"] * a.abs()).sum())
        total += a.numel()
        if float(diff.max()) > bound:
            fail(f"train card vs cpu ({arch}): {name} moved {float(diff.max()):.3g} apart "
                 f"(more than 2 lr a step)")
    if outliers > TRAIN_F32_TOL["outlier_share"] * total:
        fail(f"train card vs cpu ({arch}): {outliers} of {total} parameters outside atol "
             f"{TRAIN_F32_TOL['atol']} / rtol {TRAIN_F32_TOL['rtol']}")
    out = {"model": arch, "layers": cfg.n_layers, "seq": seq, "steps": steps,
           "loss_grad_norm_rel_err_by_step": metric_err, "param_max_abs_err": worst,
           "params_outside_tol": outliers, "params": total, "cpu_s": t_cpu, "card_s": t_card,
           "loss": [m[0] for m in m_card], "moe_routes": None}
    a_all, b_all = cpu_run["routes"], card_run["routes"]
    if a_all or b_all:
        if len(a_all) != len(b_all):
            fail(f"train card vs cpu ({arch}): {len(a_all)} routing calls on the CPU, "
                 f"{len(b_all)} on the card")
        differ = sum(int(((a[0] != b[0]) | (a[1] != b[1])).sum()) for a, b in zip(a_all, b_all))
        count = sum(a[0].numel() for a in a_all)
        out["moe_routes"] = {"differ": differ, "total": count, "share": differ / count,
                             "calls": len(a_all)}
    log(f"[train-card-vs-cpu] {arch} full width, {cfg.n_layers} layers, f32, 1 x {seq}, "
        f"{steps} steps: {json.dumps(out)}")
    del p_cpu, p_card, cpu_run, card_run
    torch.cuda.empty_cache()
    return out


# the perf levers: qwen3-1.7b served with each serving lever at its published
# config; grok-1-314b stored in fp8 (its 64 layers are 314 GB even so: one
# layer of 4.92 B parameters is 4.9 GB), gated at depth 4 and served at 13
# layers; falcon-mamba-7b trained with mamba_fused_proj
LEVER_ARCH = "qwen3-1.7b"
FP8 = "float8_e4m3fn"
GROK_FP8 = {"param_dtype": FP8, "matmul_weight_dtype": "bfloat16"}
GROK_FP8_GATE_DEPTH = 4
# 14 layers (69 GB of fp8 weights) is the most that fits a fresh process
# (chip_memory_probe.py); after this script's earlier phases the allocator's
# cache leaves room for one layer less, so the run serves 13 and fails if they
# do not fit
GROK_FP8_SERVE_DEPTH = 13
FUSED_DEPTH = 4  # falcon-mamba-7b's depth in TRAIN_RUNS
# the leaves that models/layers.py::wcast casts before their products
WCAST_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "router", "lm_head")
FUSED_LOSS_TOL = 2e-3  # tests/test_perf_levers.py's bound for mamba_fused_proj


def _fp8_rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def serve_twice(cfg, params, dev) -> dict:
    """``serve`` at the serve slice's shape, twice; the second call's
    result (its times warm), the two calls' tokens gated equal."""

    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=SERVE_SEED,
              device=dev, params=params)
    first = serve(cfg, **kw)
    warm = serve(cfg, **kw)
    if not torch.equal(first["tokens"], warm["tokens"]):
        fail(f"{cfg.name}: a second serve call generated other tokens")
    return warm


def _serve_times(res: dict) -> dict:
    return {"prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms_per_token": res["decode_s"] * 1e3 / res["decode_steps"]}


def phase_lever_serve(dev: torch.device) -> dict:
    """qwen3-1.7b at its published config on one set of weights, served
    (``serve``, batch 4 x 2048, 32 tokens) unlevered, with
    ``embed_onehot`` and with ``matmul_weight_dtype="float8_e4m3fn"``.
    Gates: the one-hot run's prefill logits and tokens bit-equal to the
    gather's; the fp8 run's hidden states and last logits bit-equal to the
    unlevered model's on weights rounded through fp8 beforehand (the tied
    head rounded for the logits alone, since the embedding gather takes the
    table uncast); the fp8 model's decode against forward at the bf16
    gate."""

    cfg = get_config(LEVER_ARCH)
    model = get_model(cfg, dev)
    torch.cuda.empty_cache()
    params = model.init_params(SERVE_SEED)
    fa_ops.reset_launches()
    runs, peaks = {}, {}
    for label, over in (("plain", {}), ("embed_onehot", {"embed_onehot": True}),
                        ("fp8_weights", {"matmul_weight_dtype": FP8})):
        torch.cuda.reset_peak_memory_stats()
        runs[label] = serve_twice(dataclasses.replace(cfg, **over), params, dev)
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
    launches = fa_ops.launches["flash_attention"]
    if launches != 6 * cfg.n_layers:
        fail(f"lever serve: flash_attention launched {launches} times in six prefills of "
             f"{cfg.n_layers} layers")
    if not (torch.equal(runs["embed_onehot"]["prefill_logits"], runs["plain"]["prefill_logits"])
            and torch.equal(runs["embed_onehot"]["tokens"], runs["plain"]["tokens"])):
        fail("embed_onehot: the prefill logits or tokens differ from the gather's")

    fp8_cfg = dataclasses.replace(cfg, matmul_weight_dtype=FP8)
    rounded = copy.deepcopy(params)
    with torch.no_grad():
        for name, t in rounded.named_parameters():
            if name.rsplit(".", 1)[-1] in WCAST_LEAVES:
                t.copy_(_fp8_rounded(t))
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                            device=dev)
    head = {"tok_emb": _fp8_rounded(params.tok_emb)} if cfg.tie_embeddings else {
        "lm_head": rounded.lm_head}
    with torch.inference_mode():
        h_fp8, _ = get_model(fp8_cfg, dev).forward(params, prompts)
        h_round, _ = model.forward(rounded, prompts)
        if not torch.equal(h_fp8, h_round):
            fail("matmul_weight_dtype fp8: hidden states differ from the unlevered model on "
                 "fp8-rounded weights")
        l_fp8 = model_layers.lm_logits(fp8_cfg, params, h_fp8[:, -1:])
        l_round = model_layers.lm_logits(cfg, types.SimpleNamespace(**head), h_round[:, -1:])
        if not torch.equal(l_fp8, l_round):
            fail("matmul_weight_dtype fp8: logits differ from the unlevered model's on "
                 "fp8-rounded weights")
        del h_fp8, h_round, rounded
        step, full = decode_vs_forward(dev, fp8_cfg, params, SERVE_PROMPT, {})
        dec_err = _held("fp8 weights decode vs forward", step, full, BF16_TOL, BF16_TOL)
        moved = float((runs["fp8_weights"]["prefill_logits"]
                       - runs["plain"]["prefill_logits"]).abs().max())
    out = {"model": LEVER_ARCH, "layers": cfg.n_layers, "launches": launches,
           "runs": {label: dict(_serve_times(res), peak_gib=peaks[label])
                    for label, res in runs.items()},
           "fp8_decode_vs_forward_max_abs_err": dec_err,
           "fp8_vs_plain_prefill_logits_max_abs_diff": moved}
    log(f"[levers] {json.dumps(out)}")
    del params, model
    torch.cuda.empty_cache()
    return out


def _grok_fp8_serve(dev: torch.device, depth: int) -> dict:
    """grok-1-314b at full width and ``depth`` layers stored in fp8, served
    twice: finite logits, tokens below the padded vocabulary, one attention
    launch a layer a prefill."""

    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=depth, **GROK_FP8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    params = get_model(cfg, dev).init_params(SERVE_SEED)
    res = serve_twice(cfg, params, dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = fa_ops.launches["flash_attention"]
    if launches != 2 * depth:
        fail(f"grok fp8 at {depth} layers: flash_attention launched {launches} times in two "
             "prefills")
    toks = res["tokens"]
    if not (bool(torch.isfinite(res["prefill_logits"]).all())
            and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())):
        fail(f"grok fp8 at {depth} layers: non-finite logits or tokens out of the vocabulary")
    del params
    return dict(_serve_times(res), layers=depth, peak_gib=peak, launches=launches)


def phase_grok_fp8(dev: torch.device) -> dict:
    """grok-1-314b with ``param_dtype="float8_e4m3fn"``,
    ``matmul_weight_dtype="bfloat16"``: at depth 4 every leaf fp8 and the
    prefill logits bit-equal to the bf16 model on the same (fp8) values;
    then served at ``GROK_FP8_SERVE_DEPTH`` layers."""

    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=GROK_FP8_GATE_DEPTH,
                              **GROK_FP8)
    model = get_model(cfg, dev)
    torch.cuda.empty_cache()
    params = model.init_params(SERVE_SEED)
    if {t.dtype for t in params.parameters()} != {torch.float8_e4m3fn}:
        fail("grok fp8: a leaf is not stored in float8_e4m3fn")
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                            device=dev)
    bf16_cfg = dataclasses.replace(cfg, param_dtype=None, matmul_weight_dtype=None)
    with torch.inference_mode():
        l_fp8, _ = model.prefill(params, {"tokens": prompts})
    with torch.no_grad():
        params.to(torch.bfloat16)  # leaf by leaf: the fp8 values in bf16
    with torch.inference_mode():
        l_bf16, _ = get_model(bf16_cfg, dev).prefill(params, {"tokens": prompts})
    if not torch.equal(l_fp8, l_bf16):
        fail("grok fp8: prefill logits differ from the bf16 model on the fp8 values")
    del params, model, l_fp8, l_bf16
    torch.cuda.empty_cache()

    served = _grok_fp8_serve(dev, GROK_FP8_SERVE_DEPTH)
    out = {"gate_depth": GROK_FP8_GATE_DEPTH, "gate": "prefill logits bit-equal to bf16",
           "served": served, "launches": served["launches"]}
    log(f"[levers] grok-1-314b fp8: {json.dumps(out)}")
    return out


def _train_one_step(dev: torch.device, cfg, batch_n: int = TRAIN_BATCH,
                    compress: bool = False) -> dict:
    """One train step of ``cfg`` from seed-0 weights on the loader's first
    batch (``batch_n`` x 2048): its loss, grad_norm, time and peak."""

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                      global_batch=batch_n, seed=0), host_id=0)
    model = get_model(cfg, dev)
    params = model.init_params(SERVE_SEED)
    state = init_state(dict(params.named_parameters()))
    step_fn = make_train_step(model, AdamWConfig(lr=TRAIN_LR), CompressionConfig(enabled=compress))
    batch = train_batch(dev, cfg, loader, 0, batch_n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        fail(f"{cfg.name} at {cfg.n_layers} layers: non-finite loss or grad_norm")
    del params, state
    return {"layers": cfg.n_layers, "loss": loss, "grad_norm": gnorm, "ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_fused_proj(dev: torch.device, plain: dict) -> dict:
    """falcon-mamba-7b at full width and depth 4, one train step (bf16,
    ``remat="block"``, 4 x 2048) with ``mamba_fused_proj`` from the weights
    and batch of ``phase_train``'s first step (``plain``: that step's
    record): the losses within 2e-3, and each run's peak."""

    cfg = train_config("falcon-mamba-7b", FUSED_DEPTH)
    fused = _train_one_step(dev, dataclasses.replace(cfg, mamba_fused_proj=True))
    if abs(fused["loss"] - plain["loss"]) > FUSED_LOSS_TOL:
        fail(f"mamba_fused_proj: first-step loss {fused['loss']} against {plain['loss']} "
             f"unfused (bound {FUSED_LOSS_TOL})")
    out = {"depth": FUSED_DEPTH, "plain": plain, "fused": fused,
           "loss_diff": abs(fused["loss"] - plain["loss"])}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[fused] falcon-mamba-7b: {json.dumps(out)}")
    return out


def phase_train_cli() -> dict:
    """``python -m repro_torch.launch.train --preset tiny`` for 40 steps with
    a checkpoint every 20, then resumed to 60: exit 0, the resume line, the
    loss falling."""

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    try:
        losses = []
        for steps, extra in ((40, []), (60, ["--resume"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--preset", "tiny",
                 "--steps", str(steps), "--ckpt-dir", root, "--ckpt-every", "20", *extra],
                env=env, capture_output=True, text=True, timeout=300)
            out[f"steps_{steps}_s"] = time.perf_counter() - t0
            for line in proc.stdout.splitlines():
                log(f"[train-cli] {line}")
            if proc.returncode != 0:
                fail(f"train CLI (--steps {steps}) exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            losses += [float(line.split()[4]) for line in proc.stdout.splitlines()
                       if line.startswith("[train] step")]
        if "[train] resumed from step 40" not in proc.stdout:
            fail("train CLI: no 'resumed from step 40' line")
        if not losses[-1] < losses[0]:
            fail(f"train CLI: loss {losses[0]} -> {losses[-1]} did not fall")
        out["losses"] = losses
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[train-cli] {json.dumps(out)}")
    return out


# the mesh phase's runs on a one-rank NCCL (1, 1) mesh, each at its published
# width, depth cut for time: (arch, layers kept (None: all), batch, tokens);
# qwen3-1.7b's checkpoint is also restored with shardings=.  The prefill's
# kernels go through local_map: qwen3's attention (hd 128) and falcon-mamba's
# scan once a layer, zamba2-2.7b's attention (hd 80) once for its group of
# six Mamba-2 layers, whisper-tiny's (hd 64) 4 + 4.  The dry-run phase's
# cells, each at full width and depth
MESH_RUNS = (("qwen3-1.7b", 2, 4, 2048), ("falcon-mamba-7b", 2, 4, 2048),
             ("zamba2-2.7b", 6, 1, 2048), ("whisper-tiny", None, 4, 448))
MESH_DECODE = 3
# (atol, rtol) a sharded step on the (1, 1) mesh may differ by from the
# plain one: nothing is split there, but the cross entropy over a split
# vocab (max, sum of exp, the label's logit) and the split-KV decode
# softmax (exp(s - max) / sum) round otherwise than torch's log_softmax and
# softmax in f32.  Adam's first step moves each weight by about lr whatever
# its gradient's size, so a small gradient whose sign rounds otherwise moves
# a weight by 2 lr (and its bf16 rounding by up to an ulp more: 4 lr).  The
# serve steps run from the same weights (before the train step) and take
# the same tokens; the prefill's caches (bf16, the Mamba states f32) and the
# logits are held at the serve tolerance (0.1, and torch.testing's bf16
# rtol); loss and grad_norm are f32
MESH_TOL = {"loss": (0.0, 1e-3), "grad_norm": (0.0, 1e-3), "params": (4 * TRAIN_LR, 1.6e-2),
            "cache": (0.1, 1.6e-2), "prefill_logits": (0.1, 1.6e-2),
            "decode_logits": (0.1, 1.6e-2)}
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"), ("qwen3-1.7b", "prefill_32k", "single"),
                ("qwen3-1.7b", "decode_32k", "single"), ("qwen3-1.7b", "train_4k", "multi"),
                ("moonshot-v1-16b-a3b", "train_4k", "single"),
                ("falcon-mamba-7b", "decode_32k", "single"),
                ("falcon-mamba-7b", "long_500k", "single"),
                ("zamba2-2.7b", "decode_32k", "single"), ("zamba2-2.7b", "long_500k", "single"),
                ("whisper-tiny", "train_4k", "single"))


def dryrun_calls(device: str) -> list[tuple[tuple, str]]:
    """The dry-run CLI calls that run ``DRYRUN_CELLS``, as ((arch, cell)
    pairs, mesh): on the card one a mesh (a subprocess takes about 10 s to
    start on the card's host), on the CPU one an arch and mesh, side by
    side (``FakeTensorMode`` is Python-bound, a core a call)."""

    calls: dict = {}
    for arch, cell, mesh in DRYRUN_CELLS:
        key = mesh if device == "cuda" else (arch, mesh)
        calls.setdefault(key, ([], mesh))[0].append((arch, cell))
    return [(tuple(pairs), mesh) for pairs, mesh in calls.values()]


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _outside(want: torch.Tensor, got: torch.Tensor, atol: float, rtol: float) -> float:
    """The largest excess of |got - want| over atol + rtol |want| (<= 0:
    within)."""

    want, got = want.float(), got.float()
    return float(((got - want).abs() - atol - rtol * want.abs()).max())


def phase_mesh(dev: torch.device) -> dict:
    """The sharded model path on a one-rank NCCL process group and a (1, 1)
    ``("data", "model")`` mesh on the card, for each of ``MESH_RUNS``: one
    train step, one prefill and ``MESH_DECODE`` greedy decode steps with
    DTensor parameters, optimizer state, batch and cache, each held against
    the same steps unsharded on the card (``MESH_TOL``, every measured max
    abs difference printed); the sharded prefill's ``flash_attention`` and
    ``ssm_scan`` launches go through ``local_map`` and are counted (the
    counts set to 0 just before the sharded run and read just after); the
    first run's checkpoint of the plain weights restored through
    ``restore_latest(shardings=)``, every leaf bit-equal.  The group is
    destroyed before the next phase.  Returns each run's record under its
    arch."""

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for i, run in enumerate(MESH_RUNS):
            out[run[0]] = _mesh_run(dev, mesh, *run, root if i == 0 else None)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    return out


def _mesh_run(dev: torch.device, mesh, arch: str, layers, batch_n: int, seq: int,
              ckpt_root: str | None) -> dict:
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    tree = tree_from_params(get_model(cfg, dev).init_params(SERVE_SEED))
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch_n, seq + 1), generator=g, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **frontend_inputs(cfg, batch_n, SERVE_SEED + 2, dev)}
    # served from the given weights, before the train step, whose update
    # rounds otherwise on the mesh; the sharded decode fed the plain one's
    # tokens, so that a near tie of random weights' logits that the
    # argmax breaks otherwise does not change the input
    kw = dict(device=dev, decode_steps=MESH_DECODE, lr=TRAIN_LR, serve_first=True)
    plain = sharded_steps(cfg, tree, batch, None, **kw)
    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    sharded = sharded_steps(cfg, tree, batch, mesh, decode_tokens=plain["decode_tokens"], **kw)
    launches = {"flash_attention": fa_ops.launches["flash_attention"],
                "ssm_scan": ssm_ops.launches["ssm_scan"]}
    restored_leaves = 0
    if ckpt_root is not None:
        ckpt = Checkpointer(TieredCheckpointStore(ckpt_root))
        ckpt.save_blocking(0, {"params": tree})
        shardings = {"params": {
            k: ({kk: (mesh, placements_for(tree[k][kk].shape, ax, mesh)) for kk, ax in v.items()}
                if isinstance(v, dict) else (mesh, placements_for(tree[k].shape, v, mesh)))
            for k, v in stacked_param_axes(cfg).items()}}
        _, restored = ckpt.restore_latest(shardings=shardings)
        ckpt.close()
        for path, leaf in _leaves(restored["params"]):
            want = dict(_leaves(tree))[path]
            if not torch.equal(_bits(leaf.to_local()), _bits(want)):
                fail(f"[mesh] {arch}: restored leaf {path} differs")
            restored_leaves += 1
    pairs = {
        "loss": [(plain["loss"], sharded["loss"])],
        "grad_norm": [(plain["grad_norm"], sharded["grad_norm"])],
        "params": [(plain["params"][k], sharded["params"][k]) for k in plain["params"]],
        "cache": [(plain["cache"][k], sharded["cache"][k]) for k in plain["cache"]],
        "prefill_logits": [(plain["prefill_logits"], sharded["prefill_logits"])],
        "decode_logits": list(zip(plain["decode_logits"], sharded["decode_logits"],
                                  strict=True)),
    }
    diffs = {k: max(_max_diff(a, b) for a, b in v) for k, v in pairs.items()}
    kernel, want = prefill_launches(cfg)
    greedy = [int((torch.argmax(a[:, -1], -1) == torch.argmax(b[:, -1], -1)).sum())
              for a, b in [pairs["prefill_logits"][0], *pairs["decode_logits"]]]
    res = {"arch": arch, "layers": cfg.n_layers, "batch": batch_n, "tokens": seq,
           "max_abs_diff": diffs, "bit_equal": {k: diffs[k] == 0.0 for k in diffs},
           "cache_max_abs_diff": {k: _max_diff(plain["cache"][k], sharded["cache"][k])
                                  for k in plain["cache"]},
           "greedy_rows_agreeing": greedy,
           "launches": launches, "kernel": fa_instance(cfg.head_dim_)
           if kernel == "flash_attention" else kernel,
           "restored_leaves": restored_leaves, "seconds": time.perf_counter() - t0}
    log(f"[mesh] {json.dumps(res)}")
    for k, (atol, rtol) in MESH_TOL.items():
        excess = max(_outside(a, b, atol, rtol) for a, b in pairs[k])
        if excess > 0:
            fail(f"[mesh] {arch} {k}: sharded differs from plain by {diffs[k]}, past atol "
                 f"{atol} + rtol {rtol} by {excess}")
    if launches[kernel] != want or sum(launches.values()) != want:
        fail(f"[mesh] {arch}: the sharded prefill launched {launches}, not {kernel} "
             f"{want} times")
    return res


def _dryrun_cmd(pairs: tuple, mesh: str, device: str, out_dir: str) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", device,
            "--only", ",".join(f"{a}:{c}" for a, c in pairs), "--mesh", mesh,
            "--out", out_dir, "--force"]


@contextlib.contextmanager
def cpu_dryruns():
    """``DRYRUN_CELLS`` with ``--device cpu`` (``FakeTensorMode``: no card,
    no allocation), in ``dryrun_calls("cpu")``, started on entry so that they
    run beside ``phase_mesh`` and the card's cells; yields (their out dir,
    the processes); on exit every one still running is killed and the
    records removed."""

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    root = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs = [subprocess.Popen(_dryrun_cmd(*c, "cpu", os.path.join(root, "cpu")), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in dryrun_calls("cpu")]
    try:
        yield root, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
        shutil.rmtree(root, ignore_errors=True)


def phase_dryrun(root: str, cpu: list) -> dict:
    """``python -m repro_torch.launch.dryrun`` over ``DRYRUN_CELLS``: rank
    0's program of the production mesh in a fake world of 512 ranks, at
    full width and depth, on the card (real allocations, each cell's peak),
    ``dryrun_calls("cuda")`` side by side (the two meshes' peaks, 26 and 10
    GB, fit one card together; each peak is its own process's, and the
    local step walls overlap); each card record's FLOPs,
    collective counts and collective bytes must equal the record of the
    same cell run on the CPU by ``cpu`` (:func:`cpu_dryruns`).  Any failure
    or out-of-memory exits nonzero."""

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    records = {}
    calls = dryrun_calls("cuda")
    procs = [subprocess.Popen(_dryrun_cmd(*call, "cuda", os.path.join(root, "cuda")), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for call in calls]
    try:
        for call, proc in zip(calls, procs):
            stdout, stderr = proc.communicate(timeout=600)
            for line in stdout.splitlines():
                if line.startswith("[dryrun] OK") or line.startswith("[dryrun] FAIL"):
                    log(f"{line} device=cuda")
            if proc.returncode != 0:
                fail(f"[dryrun] {call} on the card exited {proc.returncode}: {stderr[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    t_card = time.perf_counter() - t0
    for call, p in zip(dryrun_calls("cpu"), cpu):
        _, stderr = p.communicate(timeout=600)
        if p.returncode != 0:
            fail(f"[dryrun] {call} on the cpu exited {p.returncode}: {stderr[-3000:]}")
    for arch, cell, mesh in DRYRUN_CELLS:
        name = f"{arch}__{cell}__{mesh}.json"
        with open(os.path.join(root, "cuda", name)) as f:
            card = json.load(f)
        with open(os.path.join(root, "cpu", name)) as f:
            host = json.load(f)
        for key in ("flops_per_device", "link_bytes_per_device"):
            if card["roofline"][key] != host["roofline"][key]:
                fail(f"[dryrun] {name}: {key} {card['roofline'][key]} on the card, "
                     f"{host['roofline'][key]} on the cpu")
        for key in ("counts", "bytes_by_kind"):
            if card["collectives"][key] != host["collectives"][key]:
                fail(f"[dryrun] {name}: collective {key} {card['collectives'][key]} on "
                     f"the card, {host['collectives'][key]} on the cpu")
        records[name] = {"roofline": card["roofline"], "collectives": card["collectives"],
                         "memory": card["memory"], "step_s": card["step_s"],
                         "cpu_bytes_per_device": host["roofline"]["bytes_per_device"],
                         "model_flops": card["model_flops"],
                         "useful_flops_ratio": card["useful_flops_ratio"]}
        log(f"[dryrun] {name}: {json.dumps(records[name])}")
    log(f"[dryrun] the dry-run phase took {time.perf_counter() - t0:.1f} s "
        f"(the card's cells {t_card:.1f} s)")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"max SM clock {clock_mhz:.0f} MHz")
    t_all = time.perf_counter()
    phase_build()
    worst = phase_kernels(dev)
    worst = max(worst, phase_any_width(dev))
    model_worst = check_model_kernels(dev)
    golden_runs, golden_replays = phase_golden(dev)
    batch = sweep_trace(SWEEP_REQUESTS)
    launches, wide, swept, t_sweep, prog, sweep_times, held = phase_sweep(dev, batch)
    sanitized = phase_sanitize(dev, batch, golden_runs, swept, prog, sweep_times)
    ftl = phase_ftl_sweep(dev, batch)
    host = phase_host_engines(dev, batch, swept, t_sweep)
    service = phase_service(dev, batch, host["results"])
    any_len = phase_any_len_sweeps(dev, batch)
    examples = phase_examples(dev)
    kernels = kernel_timings(dev, batch, worst, launches, any_len)
    kernels[0]["launches_examples"] = examples["launches"]["stream_stats"]
    kernels[0]["main_path_wide_rows"] = wide
    kernels[0]["launches_ftl_sweep"] = ftl["launches"]["stream_stats"]
    kernels[0]["launches_host_engines"] = host["launches"]["stream_stats"]
    kernels[0]["launches_service"] = service["launches"]
    kernels[0]["service_scoring"] = service["kernel"]
    kernels[0]["launches_sanitize"] = sanitized["launches"]
    kernels.append(replay_row(launches, held, ftl, golden_replays, sanitized, host, any_len))
    model_launches = {}  # summed over the serve runs, per kernel instance
    for arch in SERVE_ARCHS:
        t_arch = time.perf_counter()
        res = phase_serve(dev, arch)
        log(f"[serve] {arch}: the serve phase took {time.perf_counter() - t_arch:.1f} s")
        for name, count in res["launches"].items():
            if name == "flash_attention":
                name = fa_instance(get_config(arch).head_dim_)
            model_launches[name] = model_launches.get(name, 0) + count
        if res["scan_on_model_inputs_max_abs_err"]:
            model_worst["ssm_scan"] = max(model_worst["ssm_scan"],
                                          *res["scan_on_model_inputs_max_abs_err"].values())
    for arch in SERVE_ARCHS:
        t_arch = time.perf_counter()
        phase_f32_paths(dev, arch)
        phase_card_vs_cpu(dev, arch)
        log(f"[f32] {arch}: the f32 and card-vs-cpu phases took "
            f"{time.perf_counter() - t_arch:.1f} s")
    t_levers = time.perf_counter()
    levers = phase_lever_serve(dev)
    grok_fp8 = phase_grok_fp8(dev)
    for count in (levers["launches"], grok_fp8["launches"]):  # hd 128
        model_launches["flash_attention"] = model_launches.get("flash_attention", 0) + count
    log(f"[levers] the serving lever phases took {time.perf_counter() - t_levers:.1f} s")
    t_train = time.perf_counter()
    first_steps = {}
    cases = [train_vs_cpu_case(dev, *run) for run in TRAIN_VS_CPU]
    beside = concurrent.futures.ThreadPoolExecutor(2)
    cpu_runs = beside.submit(train_cpu_halves, cases)
    cli = beside.submit(phase_train_cli)
    for run in TRAIN_RUNS:
        t_run = time.perf_counter()
        res = phase_train(dev, *run)
        log(f"[train] {run[0]}: the train phase took {time.perf_counter() - t_run:.1f} s")
        first_steps[run[0]] = dict(res["records"][0], layers=res["layers"])
        for name, count in res["launches"].items():
            if name == "flash_attention":
                name = fa_instance(get_config(run[0]).head_dim_)
            model_launches[name] = model_launches.get(name, 0) + count
    t_run = time.perf_counter()
    phase_fused_proj(dev, first_steps["falcon-mamba-7b"])
    log(f"[fused] the mamba_fused_proj phase took {time.perf_counter() - t_run:.1f} s")
    t_run = time.perf_counter()
    cli.result()
    cpu_runs = cpu_runs.result()
    beside.shutdown()
    log(f"[train-card-vs-cpu] the CPU halves and the training CLI ended "
        f"{time.perf_counter() - t_run:.1f} s after the card's train phases; the CPU halves "
        f"took {sum(r['seconds'] for r in cpu_runs):.1f} s")
    for case, cpu_run in zip(cases, cpu_runs):
        t_run = time.perf_counter()
        phase_train_card_vs_cpu(dev, case, cpu_run)
        log(f"[train-card-vs-cpu] {case['arch']}: took {time.perf_counter() - t_run:.1f} s")
    del cases, cpu_runs
    log(f"[train] the training phases took {time.perf_counter() - t_train:.1f} s")
    with cpu_dryruns() as (dry_root, dry_cpu):
        t_mesh = time.perf_counter()
        mesh = phase_mesh(dev)
        log(f"[mesh] the mesh phase took {time.perf_counter() - t_mesh:.1f} s")
        mesh_launches = {}  # per kernel row, through local_map
        for res in mesh.values():
            mesh_launches[res["kernel"]] = mesh_launches.get(res["kernel"], 0) + \
                sum(res["launches"].values())
        for name, count in mesh_launches.items():
            model_launches[name] = model_launches.get(name, 0) + count
        phase_dryrun(dry_root, dry_cpu)
    kernels += model_kernel_timings(dev, model_worst, model_launches, clock_mhz * 1e6)
    for row in kernels[-4:]:  # the model kernels' rows
        row["launches_mesh"] = mesh_launches.get(row["name"], 0)
    # serve_batched's attention runs at the smoke config's hd 16, not the row's hd 128
    kernels[-4]["launches_examples_hd16"] = examples["launches"].get("flash_attention", 0)
    kernels[-1]["launches_examples"] = examples["launches"].get("ssm_scan", 0)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
