"""Dry run of the production meshes and roofline extraction.

Runs rank 0's step of every (arch x shape cell x mesh) combination against
the production meshes -- 16 x 16 single-pod and 2 x 16 x 16 multi-pod --
in a fake world of 512 ranks (``launch/mesh.py::fake_world``: collectives
move nothing), with parameters, optimizer state, batch and cache as
DTensors of which only rank 0's local shards exist, and records:

* ``memory``: ``argument_bytes``, the exact sum of those shards, and with
  ``--device cuda`` ``peak_allocated_bytes``, the card's
  ``torch.cuda.max_memory_allocated()`` over the step (it fits, or the
  card says it does not); with ``--device cpu`` the step runs under
  ``FakeTensorMode``, nothing is allocated and the peak is ``null``;
* ``roofline``: FLOPs per device from ``FlopCounterMode``'s formulas and
  bytes per device (each op's inputs and outputs, unfused: XLA's "bytes
  accessed" counts after fusion), both counted on rank 0's local tensors,
  and the collectives rank 0 issued (:mod:`.roofline`);
* ``step_s``: the wall time of rank 0's local step on the card (a second
  step, with nothing counted), ``null`` on the CPU.

into ``experiments/dryrun_torch/<arch>__<cell>__<mesh>.json`` (idempotent;
``--force`` runs again).  Cells run the torch paths of attention and the
scan: the kernels are opaque to the FLOP and byte counts.

No loop-trip calibration.  The reference lowers each cell twice more at
small unrolled depths (``unroll_scans``) because XLA's cost analysis counts
a while-loop body once; eager torch runs and counts every layer and every
chunk, so ``calibration`` is ``null`` and ``roofline_raw`` equals
``roofline``.

Every family runs: every arch x ``applicable_cells`` x mesh, the
``long_500k`` cells of the ``ssm`` and ``hybrid`` families included (their
decode state is O(1) in context length; the hybrid's shared-attention
caches split on ``cache_seq``).

Usage (``--device`` defaults to the CUDA card):
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --cell train_4k --mesh single
    python -m repro_torch.launch.dryrun --mesh single \
        --only falcon-mamba-7b:decode_32k,zamba2-2.7b:long_500k
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force] --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCHITECTURES, SHAPE_CELLS, applicable_cells, get_config
from ..device import resolve_device
from ..distributed.sharding import placements_for, use_mesh
from ..models import get_model, input_axes, input_specs, named_param_axes
from ..optim import init_state
from .mesh import fake_world, make_production_mesh
from .roofline import CollectiveRecorder, derive_terms, model_flops_per_step
from .steps import make_prefill_step, make_serve_step, make_train_step

OUT_DIR = "experiments/dryrun_torch"
FAKE_WORLD = 2 * 16 * 16


def _rules(cfg):
    return dict(cfg.shard_rules_override) if cfg.shard_rules_override else None


def _local(t: torch.Tensor, logical, mesh, device):
    """A DTensor of ``t``'s shape and dtype laid out by ``logical``, of which
    only this rank's shard exists, zeros on ``device``."""

    from torch.distributed.tensor import DTensor

    placements = placements_for(t.shape, logical, mesh)
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    local = torch.zeros(shape, dtype=t.dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())


def _nbytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tensors)


def _build(cfg, cell, mesh, device):
    """(step, args, argument_bytes) of rank 0's step of ``cell``; must run
    under ``use_mesh(mesh)``."""

    model = get_model(cfg, device)
    params = model.abstract_params()
    param_axes = named_param_axes(cfg, params)
    for name, t in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        params.get_submodule(owner).register_parameter(leaf, torch.nn.Parameter(
            _local(t, param_axes[name], mesh, device), requires_grad=False))
    specs = input_specs(cfg, cell.kind, cell.global_batch, cell.seq_len)
    axes = input_axes(cfg, cell.kind)
    batch = {k: _local(v, axes[k], mesh, device) for k, v in specs.items()}
    args_bytes = _nbytes(params.parameters()) + _nbytes(batch.values())
    if cell.kind == "train":
        state = init_state(dict(params.named_parameters()))
        args_bytes += _nbytes([*state["m"].values(), *state["v"].values()])
        args_bytes += state["step"].numel() * state["step"].element_size()
        return make_train_step(model), (params, state, batch), args_bytes
    if cell.kind == "prefill":
        return make_prefill_step(model), (params, batch), args_bytes
    cache_axes = model.cache_axes()
    cache = {k: _local(v, cache_axes[k], mesh, device)
             for k, v in model.abstract_cache(cell.global_batch, cell.seq_len).items()}
    args_bytes += _nbytes(cache.values())
    return make_serve_step(model), (params, cache, batch["tokens"], cell.seq_len - 1), args_bytes


def _run_step(step, args, kind: str):
    with torch.no_grad() if kind != "train" else contextlib.nullcontext():
        return step(*args)


def run_cell(arch: str, cell_name: str, mesh_kind: str, out_dir: str = OUT_DIR,
             force: bool = False, override_cfg=None, tag: str = "",
             device: "torch.device | str | None" = None) -> dict:
    """Run (or read back) one cell's record; ``device`` ``None`` is the
    CUDA card."""

    cfg = override_cfg if override_cfg is not None else get_config(arch)
    dev = resolve_device(device)
    name = f"{arch}__{cell_name}__{mesh_kind}{tag}"
    out_path = os.path.join(out_dir, name + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch")
    cell = SHAPE_CELLS[cell_name]
    world = contextlib.nullcontext() if dist.is_initialized() else fake_world(FAKE_WORLD)
    with world:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type=dev.type)
        record: dict = {
            "arch": arch, "cell": cell_name, "mesh": mesh_kind,
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)), "status": "running",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        }
        if dev.type == "cuda":
            fake = contextlib.nullcontext()
            gc.collect()  # an earlier cell's tensors in reference cycles, out of the peak
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            from torch._subclasses.fake_tensor import FakeTensorMode

            fake = FakeTensorMode()
        recorder = CollectiveRecorder()
        with use_mesh(mesh, _rules(cfg)), fake:
            step, args, args_bytes = _build(cfg, cell, mesh, dev)
            with recorder:
                _run_step(step, args, cell.kind)
            step_s = None
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                _run_step(step, args, cell.kind)
                torch.cuda.synchronize(dev)
                step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    colls = recorder.collectives()
    terms = derive_terms({"flops": recorder.flops, "bytes accessed": recorder.bytes}, colls)
    n_chips = 1
    for v in record["mesh_shape"].values():
        n_chips *= v
    model_flops = model_flops_per_step(cfg, cell)
    flops_global = terms.flops * n_chips
    record.update(
        status="ok",
        step_s=step_s,
        memory={"argument_bytes": args_bytes, "peak_allocated_bytes": peak},
        collectives=colls.as_dict(),
        roofline=terms.as_dict(),
        roofline_raw=terms.as_dict(),
        calibration=None,
        model_flops=model_flops,
        useful_flops_ratio=model_flops / flops_global if flops_global else None,
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--only", default=None,
                    help="arch:cell pairs joined by commas, in place of --arch/--cell/--all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.only:
        pairs = [tuple(p.split(":")) for p in args.only.split(",")]
    elif args.all:
        pairs = [(a, c) for a in ARCHITECTURES for c in applicable_cells(get_config(a))]
    elif args.arch:
        pairs = [(args.arch, c) for c in
                 ([args.cell] if args.cell else applicable_cells(get_config(args.arch)))]
    else:
        raise SystemExit("--arch, --only or --all required")

    failures = []
    for arch, cell in pairs:
        for mesh_kind in meshes:
            label = f"{arch} x {cell} x {mesh_kind}"
            t0 = time.time()
            try:
                rec = run_cell(arch, cell, mesh_kind, args.out, force=args.force, device=dev)
                r, mem = rec["roofline"], rec["memory"]
                print(f"[dryrun] OK   {label:55s} {time.time() - t0:7.1f}s "
                      f"flops={r['flops_per_device']:.6g} "
                      f"link_bytes={r['link_bytes_per_device']:.6g} "
                      f"compute_s={r['compute_s']:.6g} memory_s={r['memory_s']:.6g} "
                      f"collective_s={r['collective_s']:.6g} dominant={r['dominant']} "
                      f"peak_allocated_bytes={mem['peak_allocated_bytes']} "
                      f"step_s={rec['step_s']}", flush=True)
            except Exception as e:  # noqa: BLE001 -- record and continue
                failures.append((label, repr(e)))
                traceback.print_exc()
                print(f"[dryrun] FAIL {label:55s} {time.time() - t0:7.1f}s "
                      f"{e!r:.120}", flush=True)
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for label, err in failures:
            print("  ", label, err[:160])
        raise SystemExit(1)
    print("\n[dryrun] all requested cells ran OK")


if __name__ == "__main__":
    main()
