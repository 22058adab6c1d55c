"""One run of one cell: set-up, the measured window, the check.

The window drives the port's public entry, ``FleetProgram.run``, sweep
after sweep, each ending in a synchronise, until ``seconds`` have passed.
The traffic mix says whether each sweep gets a trace this process has not
swept before (made from the seed and the sweep's index, off the sweep's
clock, through a new program) or repeats one trace through one program.
With ``trace`` on, the probes of the cell's own per-layer metrics are
installed and the profiler records the device over the window.

Once the window has closed and the peak device memory has been read, a
sample of the traces, drawn from the seed, is worked out again by the
plain reference on the CPU, and every sweep of each sampled trace is
compared with it (:mod:`bench.harness.check`).
"""

from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

from ..reference import sweep as ref_sweep
from ..reference.tapes import POLICIES
from . import check, registry, roofline
from .probes import GATE_KERNEL, Recorder, install
from .readings import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def trace_seed(seed: int, index: int) -> int:
    """The seed of the cell's ``index``-th trace under the run's seed."""

    ss = np.random.SeedSequence([seed & (2**64 - 1), index])
    return int(ss.generate_state(1, np.uint64)[0])


def forbidden_modules() -> list[str]:
    """Top-level names, compared whole, of loaded modules the benchmark
    must not load: ``repro_torch`` is not ``repro``."""

    return sorted({n.partition(".")[0] for n, m in list(sys.modules.items())
                   if m is not None and n.partition(".")[0] in FORBIDDEN})


def node_requests(cols: dict, cfg: dict) -> np.ndarray:
    """Requests each node receives (the reference's sharding)."""

    node = POLICIES[cfg["policy"]](np.asarray(cols["offsets"], dtype=np.int64), cfg["nodes"])
    return np.bincount(node, minlength=cfg["nodes"])


def sweep_counts(cols: dict, cfg: dict) -> dict:
    return roofline.counts(node_requests(cols, cfg), len(cols["gap_positions"]),
                           cfg["schemes"], cfg["stream_len"], cfg["adaptive_window"])


class _Profiler:
    """The torch profiler over the device (CUDA activity only); its rows
    leave out the launch spans' gates."""

    def __init__(self):
        import torch

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def rows(self) -> list[tuple[str, float]]:
        rows = []
        for e in self.prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0 and GATE_KERNEL not in e.key:
                rows.append((e.key, t / 1e6))
        return sorted(rows, key=lambda r: -r[1])


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({err})"


def _check(sweeps: list, make, cfg: dict, mix: dict, seed: int):
    """The window's sweeps against the reference: every sweep's byte
    conservation, and every sweep of a sample of its traces drawn from the
    seed in full.  Returns the readings, the failed sweeps' indices, how
    many sweeps were compared and the sampled trace indices."""

    swept = sorted({s[0] for s in sweeps})
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 1 << 32]))
    sample = sorted(rng.choice(swept, size=min(int(mix["checked_traces"]), len(swept)),
                               replace=False).tolist())
    readings = {"bytes_unconserved": sum(s[4] for s in sweeps), "int_mismatches": 0,
                "clock_rel_gap": 0.0}
    failed = {i for i, s in enumerate(sweeps) if s[4]}
    for ti in sample:
        ref = ref_sweep.sweep(make(ti), cfg)
        for i, s in enumerate(sweeps):
            if s[0] == ti:
                n_bad, gap = check.compare(s[3], ref)
                readings["int_mismatches"] += n_bad
                readings["clock_rel_gap"] = max(readings["clock_rel_gap"], gap)
                if n_bad or gap > cfg["limits"]["clock_rel_gap"]:
                    failed.add(i)
    return readings, failed, sum(s[0] in sample for s in sweeps), sample


def _per_layer(cell, w: Window, missing: dict, bench: dict, err) -> dict:
    """The cell's per-layer metrics read from a traced window; a metric
    whose probe could not be installed, or whose reader finds nothing, is
    left out and named on ``err``."""

    units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    metrics = {}
    for name, mod in cell.metrics.items():
        lost = [k for k in registry.probe_keys(mod) if k in missing]
        if lost:
            print(f"metric {name}: missing: " + "; ".join(missing[k] for k in lost), file=err)
            continue
        v = mod.read(w)
        if v is None:
            print(f"metric {name}: nothing to read in this window", file=err)
            continue
        metrics[name] = {"value": float(v), "unit": units[name]}
    return metrics


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = registry.ROOT, device: str = "cuda",
             t_start: float | None = None, out=None, err=None) -> int:
    """Run the cell once; prints the result's line last on ``out`` and
    the compared numbers with their limits last on ``err``.  Returns the
    exit code."""

    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    err = err or sys.stderr
    cell = registry.cell(workload, root)
    cfg, mix = cell.config, cell.mix

    import torch

    from repro_torch.core.fleet import FleetProgram
    from repro_torch.core.trace import TraceBatch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fresh = bool(mix["new_trace_every_sweep"])

    def make(index: int) -> dict:
        return cell.generator.generate(trace_seed(seed, index), cfg["generator_args"])

    def program(total_bytes: int):
        return FleetProgram(
            num_nodes=cfg["nodes"], schemes=tuple(cfg["schemes"]), policy=cfg["policy"],
            stream_len=cfg["stream_len"], ssd_capacity=ref_sweep.capacity(total_bytes, cfg),
            ssd=cfg["ssd"], adaptive_window=cfg["adaptive_window"],
            flush_gate=cfg["flush_gate"], device=dev)

    # -- set-up: the cell's own shapes, once each --------------------------
    index = 0
    cols = make(index)
    batch = TraceBatch.from_numpy(**cols)
    prog = program(batch.total_bytes)
    for i in range(int(mix["warm_sweeps"])):
        if fresh and i:
            index += 1
            cols = make(index)
            batch = TraceBatch.from_numpy(**cols)
            prog = program(batch.total_bytes)
        prog.run(batch)
        sync()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    # -- the window ----------------------------------------------------------
    rec, restore, missing, prof = None, None, {}, None
    counts, trace_counts = None, {}
    if trace:
        rec = Recorder(sync)
        restore, missing = install(rec, [k for mod in cell.metrics.values()
                                         for k in registry.probe_keys(mod)])
        if cuda:
            prof = _Profiler().__enter__()
    sweeps = []  # (trace index, wall s, requests, digest, bytes unconserved)
    made_s, made = 0.0, 0
    deadline = time.perf_counter() + seconds
    try:
        while True:
            if fresh:
                t0 = time.perf_counter()
                index += 1
                cols = make(index)
                batch = TraceBatch.from_numpy(**cols)
                made_s += time.perf_counter() - t0
                made += 1
            if trace:
                if index not in trace_counts:
                    trace_counts[index] = sweep_counts(cols, cfg)
                c = trace_counts[index]
                counts = c if counts is None else roofline.add(counts, c)
            sync()
            t0 = time.perf_counter()
            if fresh:
                prog = program(batch.total_bytes)
            res = prog.run(batch)
            sync()
            wall = time.perf_counter() - t0
            d = check.digest(res, cfg["schemes"])
            sweeps.append((index, wall, batch.num_requests, d,
                           check.unconserved(d, batch.total_bytes)))
            if time.perf_counter() >= deadline:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if restore is not None:
            restore()
    walls = [s[1] for s in sweeps]
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del prog, batch, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}", file=err)
        return 3
    if fresh:
        print(f"traces made off the sweeps' clock: {made} in {made_s!r} s", file=out)

    # -- the check -----------------------------------------------------------
    t0 = time.perf_counter()
    readings, failed, checked, sample = _check(sweeps, make, cfg, mix, seed)
    correct = checked > 0 and check.verdict(readings, cfg["limits"])
    print(f"check: {checked} of {len(sweeps)} sweeps against the reference "
          f"({len(sample)} traces) in {time.perf_counter() - t0!r} s", file=err)

    # -- the result ----------------------------------------------------------
    result = {"correct": correct, "attempted": len(sweeps), "failed": len(failed)}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if not trace:
        values = {"setup_s": setup_s,
                  "sweep_rate": sum(s[2] for s in sweeps) / sum(walls),
                  "peak_mib": window_peak / 2**20}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        sync()
        rows = prof.rows() if prof is not None else None
        w = Window(rec, walls, counts, sum(t for _, t in rows) if rows is not None else None,
                   sum(walls))
        metrics = _per_layer(cell, w, missing, registry.benchmark(root), err)
        if rows is not None:
            device_info["busy_s"] = w.busy_s()
            device_info["window_s"] = w.window_s
            result["breakdown"] = w.breakdown(rows)
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {k: {"value": readings[k], "limit": cfg["limits"][k]}
                        for k in check.NUMBERS}
    if cuda:
        print(f"card: {_power_limit()}", file=err)
    print(f"sweeps: {len(sweeps)}, wall (s) median {float(np.median(walls))!r}, "
          f"min {min(walls)!r}, max {max(walls)!r}"
          + (f", in order {json.dumps(walls)}" if len(walls) <= 60 else ""), file=err)
    for k in check.NUMBERS:
        print(f"check {k}: {readings[k]!r} (limit {cfg['limits'][k]!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
