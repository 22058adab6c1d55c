"""Perf hillclimb driver: rerun a dry-run cell with config variants and
compare their roofline terms with the cell's baseline record.

Each variant is a named dict of ModelConfig overrides; results land in
``experiments/hillclimb_torch/<arch>__<cell>__<mesh>__<variant>.json`` and
a comparison table prints at the end.  The baseline is the cell's record in
the dry run's out dir (run first if it is not there).  Every target runs,
``falcon_train``'s Mamba-1 variants (``mamba_fused_proj``, ``scan_chunk``,
``microbatch``) on the sharded Mamba-1 block included.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --target qwen3_train
"""

from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config
from .dryrun import OUT_DIR, run_cell

TARGETS = {
    # worst roofline fraction (memory-dominated SSM training)
    "falcon_train": ("falcon-mamba-7b", "train_4k", [
        ("rebaseline", {}),  # current code, no levers (comparability)
        ("fused_proj", dict(mamba_fused_proj=True)),
        ("fused_chunk512", dict(mamba_fused_proj=True, scan_chunk=512)),
        ("fused_chunk1024", dict(mamba_fused_proj=True, scan_chunk=1024)),
        ("chunk512_only", dict(scan_chunk=512)),
        ("fused_mb64", dict(mamba_fused_proj=True, microbatch=64)),
        ("fused_mb64_c512", dict(mamba_fused_proj=True, microbatch=64,
                                 scan_chunk=512)),
        # round 2: scan traffic ~ log2(chunk) (confirmed by chunk512 +11%)
        # -> SHRINK the chunk
        ("chunk64", dict(scan_chunk=64)),
        ("chunk32", dict(scan_chunk=32)),
        ("chunk16", dict(scan_chunk=16)),  # round 3: verify the floor
        ("mb64_c64", dict(microbatch=64, scan_chunk=64)),
    ]),
    # footprint demonstration on a cheap-compile arch: microbatching brings
    # every train cell under the HBM budget (large-scale runnability)
    "qwen3_train": ("qwen3-1.7b", "train_4k", [
        ("rebaseline", {}),
        ("mb64", dict(microbatch=64)),
        ("mb32", dict(microbatch=32)),
    ]),
    # largest absolute cell / representative of burst-absorption at ingest
    # (memory-dominated: attention-score traffic at 32k)
    "grok_prefill": ("grok-1-314b", "prefill_32k", [
        ("rebaseline", {}),  # current code, no levers (comparability)
        ("bf16_softmax", dict(softmax_dtype="bfloat16")),
        ("fp8_gather", dict(matmul_weight_dtype="float8_e4m3fn")),
        ("bf16smax_fp8", dict(softmax_dtype="bfloat16",
                              matmul_weight_dtype="float8_e4m3fn")),
        ("onehot_embed", dict(embed_onehot=True)),
        # round 2: the memory elephant is the f32 one-hot dispatch/combine
        # (T x E x C x 4B = 168 GB/layer/device at g=256)
        ("moe_g64", dict(moe_group_size=64)),
        ("moe_g64_bf16d", dict(moe_group_size=64,
                               moe_dispatch_dtype="bfloat16")),
        ("bf16d_only", dict(moe_dispatch_dtype="bfloat16")),
    ]),
    # most collective-bound cell: serving a 314B MoE re-gathers every FSDP
    # weight shard per token — replicate the (tiny) activation batch over
    # the data axis instead, so contracting-dim sharded matmuls psum small
    # activations rather than gathering huge weights
    "grok_decode": ("grok-1-314b", "decode_32k", [
        ("rebaseline", {}),  # current code, no levers (comparability)
        ("replicate_act", dict(shard_rules_override=(("batch", ()),))),
        ("fp8_weights", dict(matmul_weight_dtype="float8_e4m3fn")),
        ("replicate_fp8", dict(shard_rules_override=(("batch", ()),),
                               matmul_weight_dtype="float8_e4m3fn")),
        ("onehot_replicate", dict(embed_onehot=True,
                                  shard_rules_override=(("batch", ()),))),
        # round 2: matmul-time casts get hoisted past the gather (refuted
        # above) -> store the weights in fp8 so the collective moves fp8
        ("fp8_storage", dict(param_dtype="float8_e4m3fn",
                             matmul_weight_dtype="bfloat16")),
    ]),
}


def run_target(name: str, mesh: str = "single",
               out_dir: str = "experiments/hillclimb_torch", dryrun_dir: str = OUT_DIR,
               device=None) -> list[tuple[str, dict]]:
    """Every variant of target ``name`` beside the baseline; prints the
    table and returns its ``(variant, record)`` rows."""

    arch, cell, variants = TARGETS[name]
    rows = [("baseline", run_cell(arch, cell, mesh, dryrun_dir, device=device))]
    cfg0 = get_config(arch)
    for vname, overrides in variants:
        cfg = dataclasses.replace(cfg0, **overrides)
        rows.append((vname, run_cell(arch, cell, mesh, out_dir, override_cfg=cfg,
                                     tag=f"__{vname}", device=device)))

    print(f"\n==== hillclimb {name}: {arch} x {cell} x {mesh} ====")
    print(f"{'variant':18s} {'compute_ms':>10s} {'memory_ms':>10s} "
          f"{'coll_ms':>9s} {'step_ms':>9s} {'dom':>10s} {'peak GiB':>9s}")
    b = rows[0][1]["roofline"]
    for vname, rec in rows:
        t = rec["roofline"]
        peak = rec["memory"]["peak_allocated_bytes"]
        peak_txt = f"{peak / 2**30:9.1f}" if peak is not None else f"{'-':>9s}"
        delta = ""
        if vname != "baseline":
            key = f"{b['dominant']}_s"
            delta = f"  ({(t[key] / b[key] - 1) * 100:+.1f}% on {b['dominant']})"
        print(f"{vname:18s} {t['compute_s'] * 1e3:10.2f} "
              f"{t['memory_s'] * 1e3:10.2f} {t['collective_s'] * 1e3:9.2f} "
              f"{t['step_time_s'] * 1e3:9.2f} {t['dominant']:>10s} {peak_txt}{delta}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=sorted(TARGETS) + ["all"], default="all")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    names = sorted(TARGETS) if args.target == "all" else [args.target]
    for n in names:
        run_target(n, args.mesh, device=args.device)


if __name__ == "__main__":
    main()
