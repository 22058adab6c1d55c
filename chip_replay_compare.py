#!/usr/bin/env python3
"""The ``replay`` kernel of two checkouts, timed in turns on one CUDA card.

    python3 chip_replay_compare.py [--base DIR] [--rounds N] [--ablate]

Times the fleet replay kernel (``src/repro_torch/kernels/replay``) of this
checkout and, with ``--base``, of another one (say the parent commit,
unpacked with ``git archive`` into a directory ``.gitignore`` lists), in
turns: base, this, this, base for one round.  Each turn is a process of
its own that imports that checkout's package, so the two packed layouts
and kernels never meet.  A turn builds the inputs of ``chip_smoke.py``'s
sweep (1,000,000 requests, 64 nodes x 4 schemes = 256 lanes, range-offset
sharding, half a node's share of SSD) with the constant SSD and with the
FTL, and times on each, by CUDA events over raw launches back to back
(the inputs warm in L2, as ``chip_smoke.py::replay_held`` times them):

* the whole launch (every lane);
* one lane of each scheme alone (node 0's), whose chain sets the launch's
  time;
* ``STEADY_CALLS`` steady calls of the sweep end to end
  (``FleetProgram.run`` with its tapes cached, host clock around a
  synchronised call: stacking, packing, the copy, the launch, the read
  back).

With ``--ablate``, this checkout's turns also time, on the constant SSD,
the launch and the lanes alone of kernels built from ``replay.cu`` with one
part taken off the chain (:data:`ABLATIONS`: the HDD advance, the region
fills, SSDUP+'s threshold pass); their outputs are wrong and not read, and
what each saves is what that part costs.

Before timing, a turn holds the kernel's outputs against the same lanes on
the CPU (the plain torch version): integer fields exact, clocks within
1e-9 relative.  Prints the card's name and power limit, one JSON line a
turn, then one JSON line with every turn (also written to
``chiprun_out/replay_compare.json``).  Exits nonzero without a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
SWEEP_REQUESTS, SWEEP_NODES = 1_000_000, 64
STEADY_CALLS = 10
# Timing ablations: edits of replay.cu, each (text, replacement) applied
# exactly once, so an ablation that no longer fits the source fails loudly.
ABLATIONS = {
    "nohdd": [("  hdd_advance(g, c, st, hdd_b, nbytes, ev, allowed);\n", "  (void)hdd_b;\n")],
    "nofill": [("    fill_once(g, c, ev, nbytes, allowed, st, rem, ovf, cur_xf);\n",
                "    rem = 0;\n")],
    "nothreshold": [
        ("plus ? threshold_chunk(w, g, tape_f64, tape_u8, S, L, i, steps, lane) : INT_MAX",
         "INT_MAX"),
        ("plus ? w.thr[k] : 0.0", "0.5")],
}


def _raw_launcher(ops, kernel, p, g: list, steps: int):
    """A host call that enqueues one launch of the checkout's kernel on the
    current stream, reading nothing back.  A checkout whose ``ops`` has no
    ``launcher`` has the entry point of the one-thread-a-lane kernel, which
    took two (W, L) float64 scratch windows after the state."""

    import torch

    if hasattr(ops, "launcher"):
        return ops.launcher(p, g, steps)
    lib = kernel.load()
    _, s, n = p.tape_f64.shape
    w = p.win.shape[1]
    dev = p.win.device
    scratch = [torch.empty(w, n, dtype=torch.float64, device=dev) for _ in range(2)]
    out_f64 = torch.empty(len(ops.OUT_F64), n, dtype=torch.float64, device=dev)
    out_i64 = torch.empty(len(ops.OUT_I64), n, dtype=torch.int64, device=dev)
    args = (p.tape_f64.data_ptr(), p.tape_i64.data_ptr(), p.tape_u8.data_ptr(),
            p.lane_f64.data_ptr(), p.lane_i64.data_ptr(), p.state_f64.data_ptr(),
            p.state_i64.data_ptr(), p.win.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), out_f64.data_ptr(), out_i64.data_ptr(), *g, s, n, w, steps)

    def launch():
        if lib.replay_launch(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("replay launch failed")

    launch.buffers = (p, scratch, out_f64, out_i64)  # alive while the pointers are used
    return launch


def _cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ablated_source(text: str, name: str) -> str:
    """``replay.cu``'s ``text`` with ablation ``name`` applied."""

    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: {old!r} is not in replay.cu once")
        text = text.replace(old, new)
    return text


def _ablated(kernel, name: str):
    """The library of this checkout's kernel with ablation ``name`` applied."""

    from repro_torch.kernels.build import NVCC_FLAGS, CudaLibrary

    src = ROOT / "build" / "replay_ablations" / name / kernel.SOURCE.name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(ablated_source(kernel.SOURCE.read_text(), name))
    return CudaLibrary(src, kernel._bind, extra_flags=kernel.LIBRARY.flags[len(NVCC_FLAGS):])


def turn(tree: pathlib.Path, ablate: bool) -> dict:
    """One checkout's kernel on the sweep's inputs (runs in its own process)."""

    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.core import FleetProgram
    from repro_torch.core import engine_device as ed
    from repro_torch.kernels.replay import kernel, ops
    from repro_torch.testing.traces import sweep_trace

    dev = torch.device("cuda")
    kernel.load()
    build = [ln for ln in kernel.LIBRARY.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    batch = sweep_trace(SWEEP_REQUESTS)
    cap = max(batch.total_bytes // 2 // SWEEP_NODES, 64 << 20)
    res = {"tree": str(tree), "ptxas": build}
    for ssd in ("constant", "ftl"):
        prog = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES, policy="range-offset",
                            ssd_capacity=cap, ssd=ssd, device=dev)
        events, lanes, state0, _ = prog._lane_inputs(batch)
        kw = dict(hdd=prog.hdd, interference=prog.interference)
        p, g, steps = ed.replay_inputs(events, lanes, state0, device=dev, **kw)
        got = ops.replay_op(p, g, steps)
        want = ed.replay_lanes(events, lanes, state0, device="cpu", **kw)
        for k, v in got.items():
            v = v.cpu().numpy()
            if v.dtype.kind == "f":
                gap = np.abs(v - want[k]) / np.maximum(np.abs(want[k]), 1e-300)
                if not float(np.nanmax(gap, initial=0.0)) <= 1e-9:
                    raise SystemExit(f"{tree} {ssd}: {k} off the CPU by {np.nanmax(gap)!r}")
            elif not np.array_equal(v, want[k]):
                raise SystemExit(f"{tree} {ssd}: {k} differs from the CPU")
        alone = {}
        for si, scheme in enumerate(SCHEMES):
            i = [si * SWEEP_NODES]
            alone[scheme] = ed.replay_inputs({k: v[:, i] for k, v in events.items()},
                                             {k: v[i] for k, v in lanes.items()},
                                             {k: v[i] for k, v in state0.items()}, device=dev,
                                             **kw)
        one_lane = {scheme: _cuda_ms(_raw_launcher(ops, kernel, *lane))
                    for scheme, lane in alone.items()}
        steady = []
        prog.run(batch)
        for _ in range(STEADY_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.run(batch)
            torch.cuda.synchronize()
            steady.append(time.perf_counter() - t0)
        res[ssd] = {"ms": _cuda_ms(_raw_launcher(ops, kernel, p, g, steps)),
                    "one_lane_ms": one_lane, "shape": [steps, len(lanes["scheme"])],
                    "steady_s": steady}
        if ablate and ssd == "constant":
            libs = {name: _ablated(kernel, name) for name in ABLATIONS}
            with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
                for built in [pool.submit(lib.build) for lib in libs.values()]:
                    built.result()
            res["ablations"] = {}
            for name, lib in libs.items():
                kernel.load = lib.load  # what ops.launcher builds and loads
                res["ablations"][name] = {
                    "ms": _cuda_ms(_raw_launcher(ops, kernel, p, g, steps)),
                    "one_lane_ms": {scheme: _cuda_ms(_raw_launcher(ops, kernel, *lane))
                                    for scheme, lane in alone.items()}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, help="another checkout to time in turns")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--ablate", action="store_true",
                    help="also time this checkout's kernel with parts taken off its chain")
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn.resolve(), args.ablate)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_replay_compare: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = [ROOT]
    if args.base:
        order = [args.base.resolve(), ROOT, ROOT, args.base.resolve()]
    turns = []
    for _ in range(args.rounds):
        for tree in order:
            ablate = ["--ablate"] if args.ablate and tree == ROOT else []
            proc = subprocess.run([sys.executable, __file__, "--turn", str(tree), *ablate],
                                  capture_output=True, text=True, env=dict(os.environ))
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    out = {"card": smi, "turns": turns}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "replay_compare.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
