#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. build   — compile the three CUDA kernels (``stream_rf``,
   ``flash_attention``, ``ssm_scan``) from ``src/repro_torch/kernels/*/csrc``,
   one nvcc per source, all started together;
2. kernels — hold ``stream_stats`` and ``stream_rf`` on the card against
   their plain torch versions and the NumPy oracle, bit for bit (ties,
   offsets up to 2^40, many shapes); hold ``flash_attention`` and
   ``ssm_scan`` against their plain versions in f32 and bf16 over the
   reference tests' shapes, GQA/MQA, causal or not, Sq != Sk, ragged
   lengths and the serve slice's own shapes, at the reference tests'
   tolerances;
3. golden  — rebuild both golden traces (fingerprints must match), run
   ``FleetProgram`` on the card under both fixture policies within each
   fixture's ``device_tolerance`` (routing fields exact), and replay the
   anomaly shard under its four scheme/gate settings;
4. sweep   — the fleet main path at real size: a 1,000,000-request trace
   (64 KiB requests, offsets uniform in [0, 2^38), 16 files, 8 apps, one
   30 s gap mid-trace) over 64 nodes x 4 schemes = 256 lanes,
   range-offset sharding; kernel launch counts are reset just before and
   read just after the first sweep; bytes must be conserved, and the
   card's result must match the same sweep run on the CPU;
5. timings — both stream kernels held bit-equal to their plain versions on
   every padded shard matrix the sweep fed them, then timed at the
   largest shard's shape and at the whole trace's, beside their byte
   bound, their plain versions and ``torch.sort``;
6. serve   — the model main path: ``serve`` of qwen3-1.7b and of
   falcon-mamba-7b at full width and depth in bf16, batch 4, prompt 2048,
   32 greedy tokens, with launch counts reset just before and read just
   after; then prefill/decode times from a second call, a profile of one
   prefill and one decode step, decode against forward, and the
   ``"torch"`` prefill against the kernel prefill;
7. f32     — decode against forward and the ``"torch"`` prefill against
   the kernel prefill, at full width and depth in f32; and card against CPU: each model at full width, depth 2, one 256-token
   prompt, f32 with TF32 off, the same weights on both;
8. model-kernel timings — ``flash_attention`` and ``ssm_scan`` at the
   shapes the serve path gives them, beside their bounds, plain versions
   and (attention) ``scaled_dot_product_attention``.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
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
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FleetProgram, TraceBatch, simulate_device  # noqa: E402
from repro_torch.core.random_factor import stream_stats_batch_np  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402
from repro_torch.kernels.stream_rf import kernel, ops, ref  # noqa: E402
from repro_torch.launch.serve import pad_cache, serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
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
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:95",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:67",
}
MODEL_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "ssm_scan": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
}
# H100 SXM published peaks (dense): bf16 tensor cores, and f32 on the CUDA
# cores (the attention kernel takes no TF32); special-function units compute
# 16 exponentials per clock per SM.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16
# the serve slice: batch 4, 2048-token prompts, 32 greedy tokens
SERVE_ARCHS = ("qwen3-1.7b", "falcon-mamba-7b")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
SERVE_SEED = 0
BF16_TOL = 0.08  # tests/test_models_smoke.py (2 layers)
# Decode against forward, and the "torch" prefill against the kernel one,
# are gated in bf16 at BF16_TOL where that holds.  After falcon-mamba-7b's
# 64 bf16 layers the gaps are rounding (0.172 and 0.217 at logits up to
# 5.75, while decode against forward in f32 at full depth agrees to 4e-5),
# so there the bf16 values are recorded, argmax agreement is gated, and
# phase_f32_paths holds both comparisons in f32 at full width and depth.
BF16_GATED = ("qwen3-1.7b",)
F32_TOL = {"atol": 1e-3, "rtol": 1e-4}  # card vs CPU, f32, other summation orders
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernel_ssm_scan.py


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
    """Build every kernel of the port, one nvcc per source, all at once."""

    t0 = time.perf_counter()
    libs = (kernel.LIBRARY, fa_kernel.LIBRARY, ssm_kernel.LIBRARY)
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


# -- model kernels and the serve path ---------------------------------------

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
    (SERVE_BATCH, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True),  # qwen3-1.7b prefill
]
SSM_CASES = [  # (b, s, di, n, block_d, chunk)
    (1, 32, 16, 4, 16, 16),    # the grid of tests/test_kernel_ssm_scan.py
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 64, 32),
    (3, 96, 48, 8, 16, 32),
    (2, 40, 24, 16, 24, 8),    # DI*N not a multiple of the thread block
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


def check_model_kernels(dev: torch.device) -> dict[str, float]:
    """``flash_attention`` and ``ssm_scan`` against their plain versions on
    the card; returns each kernel's largest |error| over the cases."""

    worst = {"flash_attention": 0.0, "ssm_scan": 0.0}
    for i, (b, h, kv, sq, sk, hd, causal) in enumerate(FA_CASES):
        serve_shape = sq == SERVE_PROMPT
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
            worst["flash_attention"] = max(worst["flash_attention"], err)
    log(f"[kernels] flash_attention: {2 * len(FA_CASES)} cases within 2e-5 (f32) / "
        f"2e-2 (bf16) of the plain version, max |err| {worst['flash_attention']:.3g}")

    for i, (b, s, di, n, bd, ck) in enumerate(SSM_CASES):
        for xdtype in (torch.float32, torch.bfloat16):
            args = ssm_inputs(dev, b, s, di, n, xdtype, seed=i)
            y, h = ssm_ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
            yr, hr = ssm_ref.ssm_scan_ref(*args)
            label = f"ssm_scan {(b, s, di, n)} x {xdtype}"
            tol = SSM_TOL[xdtype]
            worst["ssm_scan"] = max(worst["ssm_scan"], _held(label + " y", y, yr, tol, tol),
                                    _held(label + " h_last", h, hr, 1e-3, 1e-3))
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


def phase_serve(dev: torch.device, arch: str) -> dict:
    """The model main path at full width and depth, then its checks."""

    cfg = get_config(arch)
    name = "flash_attention" if cfg.family == "dense" else "ssm_scan"
    model = get_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init_params(SERVE_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=SERVE_SEED,
              device=dev, params=params)

    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    res = serve(cfg, **kw)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_ops.launches["flash_attention"],
                "ssm_scan": ssm_ops.launches["ssm_scan"]}
    if launches[name] < cfg.n_layers:
        fail(f"{arch}: {name} launched {launches[name]} times on the main path, "
             f"expected >= {cfg.n_layers} (one per layer of the prefill)")
    toks = res["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN):
        fail(f"{arch}: generated {tuple(toks.shape)} tokens")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{arch}: generated token ids outside the vocabulary")
    if not bool(torch.isfinite(res["prefill_logits"]).all()):
        fail(f"{arch}: non-finite prefill logits")
    log(f"[serve] {arch}: launches on the main path {json.dumps(launches)}; "
        f"first call prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
        f"{res['decode_s'] * 1e3:.1f} ms; seq0 {toks[0, :12].tolist()}")

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
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gp,
                                device=dev)
        pre_wall, pre_busy, pre_ops = device_time(
            lambda: model.prefill(params, {"tokens": prompts}))
        top = top_device_ops(lambda: model.prefill(params, {"tokens": prompts}))
        logits, cache = model.prefill(params, {"tokens": prompts})
        cache = pad_cache(cache, 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        model.decode_step(params, cache, tok, SERVE_PROMPT)
        dec_wall, dec_busy, dec_ops = device_time(
            lambda: model.decode_step(params, cache, tok, SERVE_PROMPT), iters=3)
        del cache, logits
    log(f"[serve] {arch}: profiled prefill {pre_wall * 1e3:.1f} ms, device busy "
        f"{pre_busy * 1e3:.1f} ms over {pre_ops} ops; profiled decode "
        f"step {dec_wall * 1e3 / 3:.1f} ms, device busy {dec_busy * 1e3 / 3:.2f} ms "
        f"({dec_busy / dec_wall:.1%}) over {dec_ops // 3} ops a step")
    log(f"[serve] {arch}: prefill's largest device ops (ms, calls): {json.dumps(top)}")

    with torch.inference_mode():
        # decode against forward: prefill(tokens[:-1]) + one step vs prefill(tokens);
        # the scan kernel needs S divisible by min(scan_chunk, S) for both lengths
        n = SERVE_PROMPT if cfg.family == "dense" else cfg.scan_chunk
        g = torch.Generator(device=dev).manual_seed(7)
        seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, n), generator=g, device=dev)
        full, _ = model.prefill(params, {"tokens": seq})
        _, cache = model.prefill(params, {"tokens": seq[:, :-1]})
        step, _ = model.decode_step(params, pad_cache(cache, 1), seq[:, -1:], n - 1)
        del cache
        dec_err = float((step[:, 0].float() - full[:, 0].float()).abs().max())
        if arch in BF16_GATED:
            _held(f"{arch} decode vs forward", step[:, 0], full[:, 0], BF16_TOL, BF16_TOL)
        dec_agree = _agreement(step[:, 0], full[:, 0])
        if dec_agree < 0.5:
            fail(f"{arch}: decode and forward argmax agree on {dec_agree:.0%} of rows")

        # the same prefill through the layer's own paths ("torch")
        plain = get_model(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"),
                          dev)
        hk, _ = model.forward(params, prompts)
        lk = model_layers.lm_logits(cfg, params, hk[:, -32:]).float()
        del hk
        ht, _ = plain.forward(params, prompts)
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
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
        "launches": launches,
        "prefill_ms": warm["prefill_s"] * 1e3,
        "decode_ms_per_token": warm["decode_s"] * 1e3 / warm["decode_steps"],
        "decode_tokens_per_s": warm["decode_tokens_per_s"],
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / warm["prefill_s"],
        "first_call_prefill_ms": res["prefill_s"] * 1e3,
        "peak_gib": peak,
        "decode_vs_forward_max_abs_err": dec_err, "decode_vs_forward_argmax": dec_agree,
        "decode_vs_forward_len": n,
        "torch_vs_kernel_max_abs_err": path_err, "torch_vs_kernel_argmax": path_agree,
        "profiled_prefill_ms": pre_wall * 1e3, "prefill_busy_ms": pre_busy * 1e3,
        "prefill_device_ops": pre_ops, "profiled_decode_step_ms": dec_wall * 1e3 / 3,
        "decode_step_busy_ms": dec_busy * 1e3 / 3, "decode_step_device_ops": dec_ops // 3,
        "prefill_top_device_ops": top,
    }
    log(f"[serve] {json.dumps(out)}")
    del params, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def top_device_ops(fn, k: int = 8) -> list:
    """The ``k`` device ops with the most device time in one call of
    ``fn``: [name, ms, calls]."""

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append([e.key[:80], t / 1e3, e.count])
    return sorted(rows, key=lambda r: -r[1])[:k]


def phase_f32_paths(dev: torch.device, arch: str) -> dict:
    """At full width and depth in f32 (TF32 off): decode against forward
    (prefill(tokens[:-1]) + one decode step vs prefill(tokens)), and the
    ``"torch"`` prefill against the kernel prefill."""

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = get_model(cfg, dev)
    plain = get_model(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"), dev)
    params = model.init_params(SERVE_SEED)
    # the scan kernel needs S divisible by min(scan_chunk, S) for both lengths
    n = SERVE_PROMPT if cfg.family == "dense" else cfg.scan_chunk
    g = torch.Generator(device=dev).manual_seed(7)
    seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, n), generator=g, device=dev)
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": seq})
        _, cache = model.prefill(params, {"tokens": seq[:, :-1]})
        step, _ = model.decode_step(params, pad_cache(cache, 1), seq[:, -1:], n - 1)
        del cache
        torch_full, _ = plain.prefill(params, {"tokens": seq})
    tol = (F32_TOL["atol"], F32_TOL["rtol"])
    out = {"tokens": n,
           "decode_vs_forward": _held(f"{arch} decode vs forward (f32)", step[:, 0],
                                      full[:, 0], *tol),
           "torch_vs_kernel": _held(f"{arch} torch vs kernel prefill (f32)", torch_full[:, 0],
                                    full[:, 0], *tol)}
    log(f"[f32] {arch}: full width and depth, {n} tokens: max |logit diff| decode vs "
        f"forward {out['decode_vs_forward']:.3g}, torch vs kernel prefill "
        f"{out['torch_vs_kernel']:.3g} (atol {tol[0]}, rtol {tol[1]})")
    del params, model, plain
    torch.cuda.empty_cache()
    return out


def phase_card_vs_cpu(dev: torch.device, arch: str) -> float:
    """Full width, depth 2, f32, TF32 off: one 256-token prompt through the
    same weights on the card (kernels) and on the CPU (plain versions)."""

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    model = get_model(cfg, dev)
    params = model.init_params(SERVE_SEED)
    cpu_model = get_model(cfg, "cpu")
    cpu_copy = copy.deepcopy(params).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        card, _ = model.prefill(params, {"tokens": toks.to(dev)})
        cpu, _ = cpu_model.prefill(cpu_copy, {"tokens": toks})
    err = _held(f"{arch} card vs cpu (f32, depth 2)", card.cpu(), cpu, F32_TOL["atol"],
                F32_TOL["rtol"])
    log(f"[card-vs-cpu] {arch}: full width, 2 layers, 256 tokens, f32: max |logit diff| "
        f"{err:.3g} (atol {F32_TOL['atol']}, rtol {F32_TOL['rtol']})")
    del params, cpu_copy, model
    torch.cuda.empty_cache()
    return err


def raw_fa_launch(q, k, v):
    """The attention kernel's C entry point with no wrapper around it, on
    the model's (B, S, H, hd) layout."""

    lib = fa_kernel.load()
    o = torch.empty_like(q)
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            1 if q.dtype == torch.bfloat16 else 0, q.shape[0], q.shape[2], k.shape[2],
            q.shape[1], k.shape[1], q.shape[3], 1.0 / math.sqrt(q.shape[3]), 1,
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


def model_kernel_timings(dev: torch.device, worst: dict, launches: dict,
                         sm_clock_hz: float) -> list[dict]:
    """Both model kernels at the serve slice's shapes, in bf16: ``ms`` from
    CUDA events over back-to-back raw launches, ``plain_ms`` and
    ``library_ms`` from CUDA events over calls."""

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []

    b, h, kv, s, _, hd, _ = FA_CASES[-1]
    q, k, v = fa_inputs(dev, b, h, kv, s, s, hd, torch.bfloat16, seed=5, bshd=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = 4 * b * h * (s * (s + 1) // 2) * hd  # causal: the pairs qpos >= kpos
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(raw_fa_launch(q, k, v), iters=20, warmup=3)
    out.append({
        "name": "flash_attention", "route": "cuda", "source": MODEL_SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": launches["flash_attention"],
        "max_abs_err": worst["flash_attention"],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: fa_ref.flash_attention_ref(qt, kt, vt, causal=True),
                            iters=5, warmup=1),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20, warmup=3),
        "call_ms": cuda_ms(lambda: fa_ops.flash_attention_bshd(q, k, v), iters=20, warmup=3),
        "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bfloat16",
                  "causal": True, "layout": "bshd"},
        "flops": flops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "library_call": "F.scaled_dot_product_attention(q, k, v, is_causal=True, "
                        "enable_gqa=True): a yardstick the port never calls",
    })
    del q, k, v, qt, kt, vt

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
    model_worst = check_model_kernels(dev)
    phase_golden(dev)
    batch = sweep_trace()
    launches = phase_sweep(dev, batch)
    kernels = kernel_timings(dev, batch, worst, launches)
    model_launches = {}
    for arch in SERVE_ARCHS:
        res = phase_serve(dev, arch)
        for name, count in res["launches"].items():
            model_launches[name] = max(model_launches.get(name, 0), count)
    for arch in SERVE_ARCHS:
        phase_f32_paths(dev, arch)
        phase_card_vs_cpu(dev, arch)
    kernels += model_kernel_timings(dev, model_worst, model_launches, clock_mhz * 1e6)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
