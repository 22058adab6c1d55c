#!/usr/bin/env python3
"""How much fits one CUDA card: the depth and memory readings behind
chip_smoke.py's fixed settings.

    python3 chip_memory_probe.py

1. grok-1-314b stored in fp8 (``param_dtype="float8_e4m3fn"``,
   ``matmul_weight_dtype="bfloat16"``), served as chip_smoke.py serves it
   (batch 4 x 2048, 32 tokens, twice): the largest depth that fits.  The
   search starts at the depth the card's memory allows by reckoning (the
   layers' fp8 bytes beside the fp8 embedding and head and the init's f32
   draw of the largest leaf and its scaled copy), goes a layer up while a
   depth fits and a layer down while it does not;
2. falcon-mamba-7b trained with ``mamba_fused_proj`` (bf16,
   ``remat="block"``, 4 x 2048, one step from seed-0 weights): the step at
   depth 8, then the largest depth that trains, searched the same way from
   the depth reckoned from the depth-8 peak (a layer adds its weight,
   gradient and AdamW moments, 12 bytes a parameter, and its saved bf16
   input);
3. zamba2-2.7b whole, one train step at 1 x 2048 with gradient compression
   off and on: each step's peak, and the memory allocated just before, at
   most during and just after the gradients' compression.

A depth that does not fit is found by catching the card's out-of-memory
error: that is what this script measures (chip_smoke.py catches nothing).
Prints the card's name and power limit and, as its last line, one JSON
object of the readings.  Needs one card and about 5 minutes.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402


def fits(run, depth: int):
    """``run(depth)``, or None if the card runs out of memory."""

    gc.collect()
    torch.cuda.empty_cache()
    try:
        return run(depth)
    except torch.cuda.OutOfMemoryError:
        cs.log(f"[probe] {depth} layers: out of device memory")
        return None
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def largest_depth(run, depth: int, lo: int, hi: int) -> tuple[dict | None, dict]:
    """From ``depth``, a layer up while ``run`` fits and a layer down while
    it does not, within (lo, hi]: the largest depth's result, and each depth
    tried with whether it fit."""

    tried, best = {}, None
    while depth not in tried and lo < depth <= hi:
        tried[depth] = fits(run, depth)
        if tried[depth] is not None and (best is None or depth > best["layers"]):
            best = tried[depth]
        depth = depth + 1 if tried[depth] is not None else depth - 1
    return best, {d: r is not None for d, r in sorted(tried.items())}


def layer_params(cfg) -> int:
    return (dataclasses.replace(cfg, n_layers=1).param_count()
            - dataclasses.replace(cfg, n_layers=0).param_count())


def grok_fp8_depth(dev: torch.device) -> dict:
    full = cs.get_config("grok-1-314b")
    per_layer = layer_params(full)  # fp8: a byte a parameter
    rest = full.param_count() - full.n_layers * per_layer  # embedding, head, final norm
    largest_leaf = full.n_experts * full.d_model * full.d_ff
    total = torch.cuda.mem_get_info(dev)[1]
    depth = int((total - rest - 2 * 4 * largest_leaf - 2**30) // per_layer)
    best, tried = largest_depth(lambda d: cs._grok_fp8_serve(dev, d), depth, 0, full.n_layers)
    return {"reckoned": depth, "largest": best, "tried": tried, "layer_bytes_fp8": per_layer}


def fused_depth(dev: torch.device) -> dict:
    cfg = dataclasses.replace(cs.train_config("falcon-mamba-7b", cs.FUSED_DEPTH),
                              mamba_fused_proj=True)
    at8 = cs._train_one_step(dev, cfg)
    full = cs.get_config("falcon-mamba-7b")
    per_layer = 12 * layer_params(full) + cs.TRAIN_BATCH * cs.TRAIN_SEQ * full.d_model * 2
    total = torch.cuda.mem_get_info(dev)[1]
    depth = cs.FUSED_DEPTH + int((total - at8["peak_gib"] * 2**30 - 2**30) // per_layer)
    best, tried = largest_depth(
        lambda d: cs._train_one_step(dev, dataclasses.replace(cfg, n_layers=d)),
        depth, cs.FUSED_DEPTH, full.n_layers)
    return {"depth_8": at8, "reckoned": depth, "per_layer_bytes_reckoned": per_layer,
            "largest": best, "tried": tried}


def zamba2_compression_memory(dev: torch.device) -> dict:
    """The step's peak with compression off and on, and the allocation
    around ``_compress_as_reference`` (wrapped for the reading; the train
    step looks it up at each call)."""

    inner = steps._compress_as_reference
    seen: dict = {}

    def reading(grads, cfg, every=1):
        torch.cuda.synchronize()
        seen["peak_before_gib"] = torch.cuda.max_memory_allocated() / 2**30
        seen["allocated_before_gib"] = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        out = inner(grads, cfg, every)
        torch.cuda.synchronize()
        seen["peak_during_gib"] = torch.cuda.max_memory_allocated() / 2**30
        seen["allocated_after_gib"] = torch.cuda.memory_allocated() / 2**30
        return out

    cfg = cs.train_config("zamba2-2.7b", None)
    out = {}
    steps._compress_as_reference = reading
    try:
        for compress in (False, True):
            seen.clear()
            step = cs._train_one_step(dev, cfg, batch_n=1, compress=compress)
            step["peak_gib"] = max(step["peak_gib"], seen["peak_before_gib"])
            out["on" if compress else "off"] = dict(step, compression=dict(seen))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        steps._compress_as_reference = inner
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_memory_probe: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    cs.phase_build()
    out = {"device": smi, "grok_fp8_serve": grok_fp8_depth(dev),
           "falcon_mamba_fused_train": fused_depth(dev),
           "zamba2_train_compression": zamba2_compression_memory(dev)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
