#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. build   — compile the CUDA ``stream_rf`` kernel from
   ``src/repro_torch/kernels/stream_rf/csrc`` with nvcc;
2. kernels — hold ``stream_stats`` and ``stream_rf`` on the card against
   their plain torch versions and the NumPy oracle, bit for bit (ties,
   offsets up to 2^40, many shapes), and time them;
3. golden  — rebuild both golden traces (fingerprints must match), run
   ``FleetProgram`` on the card under both fixture policies within each
   fixture's ``device_tolerance`` (routing fields exact), and replay the
   anomaly shard under its four scheme/gate settings;
4. sweep   — the main path at real size: a 1,000,000-request trace
   (64 KiB requests, offsets uniform in [0, 2^38), 16 files, 8 apps, one
   30 s gap mid-trace) over 64 nodes x 4 schemes = 256 lanes,
   range-offset sharding; kernel launch counts are reset just before and
   read just after the first sweep; bytes must be conserved, and the
   card's result must match the same sweep run on the CPU;
5. timings — both kernels held bit-equal to their plain versions on
   every padded shard matrix the sweep fed them, then timed at the
   largest shard's shape and at the whole trace's, beside their byte
   bound, their plain versions and ``torch.sort``.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import FleetProgram, TraceBatch, simulate_device  # noqa: E402
from repro_torch.core.random_factor import stream_stats_batch_np  # noqa: E402
from repro_torch.kernels.stream_rf import kernel, ops, ref  # noqa: E402
from repro_torch.testing import golden  # noqa: E402
from repro_torch.testing.traces import golden_trace, trace_fingerprint  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SWEEP_REQUESTS = 1_000_000
SWEEP_NODES = 64
SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
KERNEL_SOURCE = "src/repro_torch/kernels/stream_rf/csrc/stream_rf.cu"
REPLACES = {
    "stream_stats": "src/repro/kernels/stream_rf/kernel.py:135",
    "stream_rf": "src/repro/kernels/stream_rf/kernel.py:97",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# -- inputs -------------------------------------------------------------


def sweep_trace(n: int = SWEEP_REQUESTS, seed: int = 0) -> TraceBatch:
    """Random-heavy multi-app trace with one mid-trace compute gap."""

    rng = np.random.default_rng(seed)
    return TraceBatch(
        offsets=rng.integers(0, 1 << 38, size=n).astype(np.int64),
        sizes=np.full(n, 64 << 10, dtype=np.int64),
        file_ids=rng.integers(0, 16, size=n).astype(np.int64),
        app_ids=rng.integers(0, 8, size=n).astype(np.int64),
        times=np.zeros(n),
        gap_positions=np.asarray([n // 2], dtype=np.int64),
        gap_seconds=np.asarray([30.0]),
    )


def kernel_cases(rng: np.random.Generator):
    """(name, offsets, sizes) matrices: random up to 2^40, heavy ties of
    differing sizes, contiguous and reversed rows."""

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
    t0 = time.perf_counter()
    path = kernel.build()
    kernel.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(dev: torch.device) -> float:
    """Every case bit-equal on the card; returns the largest |error|."""

    rng = np.random.default_rng(12)
    worst = 0
    cases = 0
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
        cases += 1
    log(f"[kernels] {cases} cases bit-equal to the plain version and the "
        "NumPy oracle")
    return float(worst)


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
    us, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            us += t
            count += e.count
    return wall, us / 1e6, count


def profiled(fn, iters: int = 50) -> tuple[float, int]:
    """Device ms per call of the torch ops ``fn`` runs, and device ops
    per call.  (The profiler does not see the kernel itself: its library
    links the CUDA runtime statically, outside the profiler's hooks.)"""

    fn()
    torch.cuda.synchronize()
    _, busy, count = device_time(fn, iters)
    return busy * 1e3 / iters, count // iters


def raw_launch(o: torch.Tensor, s: torch.Tensor, with_dist: bool):
    """The kernel's C entry point with no wrapper around it, so that
    back-to-back launches keep the device busy and CUDA events time the
    kernel (about a microsecond of ctypes per launch)."""

    lib = kernel.load()
    m, n = o.shape
    rf = torch.empty(m, dtype=torch.int64, device=o.device)
    dist = torch.empty(m, dtype=torch.int64, device=o.device)
    args = (o.data_ptr(), s.data_ptr(), rf.data_ptr(),
            dist.data_ptr() if with_dist else None, m, n,
            torch.cuda.current_stream().cuda_stream)
    if lib.stream_stats_launch(*args) != 0:
        fail("raw stream_stats launch failed")

    def launch():
        lib.stream_stats_launch(*args)

    launch.buffers = (o, s, rf, dist)  # alive while the pointers are used
    return launch


def check_shards(dev: torch.device, shards: list[TraceBatch]) -> int:
    """Both kernels bit-equal to their plain versions on every padded
    shard matrix the sweep feeds them; returns the largest |error|."""

    worst = 0
    for i, b in enumerate(shards):
        o_np, s_np, _ = b.padded_stream_matrix()
        o = torch.from_numpy(o_np).to(dev)
        s = torch.from_numpy(s_np).to(dev)
        rf_p, dist_p = ref.stream_stats_ref(o, s)
        rf_k, _, dist_k = ops.stream_stats_op(o, s)
        for label, got, want in (
            ("stream_stats rf", rf_k, rf_p),
            ("stream_stats dist", dist_k, dist_p),
            ("stream_rf", ops.stream_rf_op(o, s), rf_p),
        ):
            if got.numel():
                worst = max(worst, int((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"sweep shard {i} {tuple(o.shape)}: {label} differs "
                     "from the plain version")
    log(f"[kernels] {len(shards)} sweep shard matrices bit-equal to the "
        "plain version")
    return worst


def kernel_timings(dev: torch.device, batch: TraceBatch, worst: float,
                   launches: dict) -> list[dict]:
    """Times at the main path's shape: the largest shard's padded stream
    matrix of the sweep (one launch per shard), plus the whole trace as
    one matrix.  ``ms``: CUDA events over back-to-back raw launches;
    ``plain_ms``/``library_ms``: device time from the profiler;
    ``call_ms``: CUDA events per wrapper call, host overhead included."""

    prog = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES,
                        policy="range-offset", device=dev)
    shards = prog.shard(batch)
    worst = float(max(worst, check_shards(dev, shards)))
    shard = max(shards, key=lambda b: b.num_requests)
    rows = {}
    for key, b in (("", shard), ("_whole_trace", batch)):
        o, s, _ = b.padded_stream_matrix()
        rows[key] = (torch.from_numpy(o).to(dev), torch.from_numpy(s).to(dev))
    out = []
    for name, with_dist in (("stream_stats", True), ("stream_rf", False)):
        op = ops.stream_stats_op if with_dist else ops.stream_rf_op
        plain = ref.stream_stats_ref if with_dist else ref.stream_rf_ref
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": worst}
        for key, (o, s) in rows.items():
            m, n = o.shape
            plain_ms, plain_ops = profiled(lambda: plain(o, s))
            lib_ms, _ = profiled(lambda: torch.sort(o, dim=1, stable=True))
            entry.update({
                f"ms{key}": cuda_ms(raw_launch(o, s, with_dist), iters=1000),
                f"plain_ms{key}": plain_ms,
                f"bound_ms{key}": bound_ms(m, n, with_dist),
                f"bound_by{key}": "bytes",
                f"library_ms{key}": lib_ms,
                f"call_ms{key}": cuda_ms(lambda: op(o, s)),
                f"plain_device_ops{key}": plain_ops,
                f"shape{key}": [m, n],
            })
        entry["library_call"] = ("torch.sort(offsets, dim=1, stable=True): the "
                                 "sort alone, a yardstick the port never calls")
        out.append(entry)
    return out


def phase_golden(dev: torch.device) -> None:
    for wl in golden.FIXTURE_WORKLOADS:
        batch = golden_trace(wl)
        cap = golden._node_capacity(batch.total_bytes)
        for policy in golden.FIXTURE_POLICIES:
            res = FleetProgram(num_nodes=golden.FIXTURE_NODES,
                               schemes=golden.FIXTURE_SCHEMES, policy=policy,
                               ssd_capacity=cap, device=dev).run(batch)
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


def phase_sweep(dev: torch.device, batch: TraceBatch) -> dict:
    cap = max(batch.total_bytes // 2 // SWEEP_NODES, 64 << 20)
    lanes = SWEEP_NODES * len(SCHEMES)
    prog = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES,
                        policy="range-offset", ssd_capacity=cap, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = prog.run(batch)  # scores every shard on the card, builds tapes
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.launches)
    if launches["stream_stats"] < SWEEP_NODES:
        fail(f"stream_stats launched {launches['stream_stats']} times on the "
             f"main path, expected >= {SWEEP_NODES}")
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = prog.run(batch)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    t_best = min(steady)
    t_prof, busy, n_ops = device_time(lambda: prog.run(batch))
    totals = {s: fr.total_bytes for s, fr in res.items()}
    for s, fr in res.items():
        if fr.total_bytes != batch.total_bytes:
            fail(f"{s}: sweep routed {fr.total_bytes} bytes of {batch.total_bytes}")
        vals = [v for r in fr.node_results
                for v in (r.io_seconds, r.total_seconds, r.blocked_seconds)]
        if not all(math.isfinite(v) and v >= 0 for v in vals):
            fail(f"{s}: non-finite or negative clocks in the sweep")
    log(f"[sweep] {batch.num_requests:,} requests, {SWEEP_NODES} nodes x "
        f"{len(SCHEMES)} schemes = {lanes} lanes, ssd_capacity {cap}")
    log(f"[sweep] first call {t_first:.3f} s (scoring + tapes + replay), "
        f"steady {json.dumps(steady)} s, best {t_best:.3f} s = "
        f"{lanes / t_best:.1f} lanes/s")
    log(f"[sweep] profiled steady run {t_prof:.3f} s: device busy "
        f"{busy:.4f} s ({busy / t_prof:.2%}), {n_ops} device ops")
    log(f"[sweep] launches on the main path: {json.dumps(launches)}")
    log(f"[sweep] total bytes per scheme: {json.dumps(totals)}")

    # the same sweep on the CPU: integer fields exact, clocks to 1e-9
    t0 = time.perf_counter()
    cpu = FleetProgram(num_nodes=SWEEP_NODES, schemes=SCHEMES,
                       policy="range-offset", ssd_capacity=cap,
                       device="cpu").run(batch)
    worst = 0.0
    for s in SCHEMES:
        for a, b in zip(res[s].node_results, cpu[s].node_results):
            for f in ("bytes_to_ssd", "bytes_to_hdd_direct", "flushes",
                      "peak_ssd_occupancy"):
                if getattr(a, f) != getattr(b, f):
                    fail(f"{s}.{f}: card {getattr(a, f)} != cpu {getattr(b, f)}")
            for f in ("io_seconds", "total_seconds", "blocked_seconds",
                      "flush_paused_seconds"):
                x, y = getattr(a, f), getattr(b, f)
                rel = abs(x - y) / max(abs(y), 1e-300)
                worst = max(worst, rel)
                if rel > 1e-9:
                    fail(f"{s}.{f}: card {x!r} vs cpu {y!r}")
    log(f"[sweep] card == cpu: integer fields exact, clocks max rel diff "
        f"{worst:.3g} (cpu run {time.perf_counter() - t0:.1f} s)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    phase_build()
    worst = phase_kernels(dev)
    phase_golden(dev)
    batch = sweep_trace()
    launches = phase_sweep(dev, batch)
    kernels = kernel_timings(dev, batch, worst, launches)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
