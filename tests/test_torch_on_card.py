"""The port's CUDA kernels and serve path on a CUDA card.

Every test here needs a card and skips without one; the file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_on_card.py

Each kernel is held against its plain torch version on the same inputs,
at the tolerances of the reference's kernel tests.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, ShardedLoader
from repro_torch.launch.steps import make_train_step
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax, tree_from_params
from repro_torch.optim import AdamWConfig, init_state, linear_warmup_cosine
from repro_torch import tracing
from repro_torch.analysis import sanitizing
from repro_torch.core import FleetProgram, compute_stream_scores
from repro_torch.core import engine_device as ed
from repro_torch.core.random_factor import stream_stats_batch_np
from repro_torch.core.trace import _score_shards_kernel
from repro_torch.distributed.sharding import assign_nodes
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.replay import ops as replay_ops
from repro_torch.kernels.tapes import ops as tapes_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.kernels.stream_rf import kernel as rf_kernel
from repro_torch.kernels.stream_rf import ops as rf_ops
from repro_torch.kernels.stream_rf import ref as rf_ref
from repro_torch.launch.serve import serve
from repro_torch.service import BurstBufferService, FaultInjector, poisson_arrivals, scripted
from repro_torch.testing.service import ReshardCountingService, same_service_result
from repro_torch.testing import golden, stream_rows
from repro_torch.testing.golden import fleet_result_to_dict
from repro_torch.testing.traces import golden_trace, sweep_trace

import tapes_cases  # the tapes kernel's cases, NumPy only

pytestmark = pytest.mark.cuda

FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", [
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 128, 128, 64, True),
    (1, 6, 1, 128, 128, 32, True),
    (1, 2, 2, 256, 256, 128, False),
    (1, 2, 2, 64, 192, 64, False),
    (2, 4, 2, 100, 77, 128, True),   # ragged, Sq > Sk
    (1, 4, 4, 33, 33, 16, True),
    (1, 4, 4, 130, 130, 80, True),   # hd 80, MHA (stablelm-3b, zamba2-2.7b)
    (2, 6, 2, 100, 77, 80, True),    # hd 80, GQA, ragged
    (1, 2, 1, 64, 200, 80, False),   # hd 80, Sk not a multiple of 128
])
def test_flash_attention_vs_plain(card, b, h, kv, sq, sk, hd, causal, dtype):
    g = torch.Generator(device=card).manual_seed(sq * 7 + hd)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, kv, sk, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, kv, sk, hd, generator=g, device=card).to(dtype)
    got = fa_ops.flash_attention_op(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])
    got_bshd = fa_ops.flash_attention_bshd(q.transpose(1, 2).contiguous(),
                                           k.transpose(1, 2).contiguous(),
                                           v.transpose(1, 2).contiguous(), causal=causal)
    assert torch.equal(got_bshd.transpose(1, 2), got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(300, 200), (200, 333)])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_flash_attention_bf16_every_head_dim(card, hd, sq, sk, causal):
    """Each template instance of the tensor-core kernel, on ragged lengths
    (not multiples of its 128-row tiles) with GQA."""

    g = torch.Generator(device=card).manual_seed(hd + sq)
    q = torch.randn(2, 4, sq, hd, generator=g, device=card).bfloat16()
    k = torch.randn(2, 2, sk, hd, generator=g, device=card).bfloat16()
    v = torch.randn(2, 2, sk, hd, generator=g, device=card).bfloat16()
    got = fa_ops.flash_attention_op(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    got_bshd = fa_ops.flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), causal=causal)
    assert torch.equal(got_bshd.transpose(1, 2), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_at_the_whisper_encoder_shape(card, dtype):
    """whisper-tiny's encoder self attention: (4, 1500, 6, 64) in the
    model's (B, S, H, hd) layout, non-causal, 1,500 frames a ragged last
    tile."""

    g = torch.Generator(device=card).manual_seed(1500)
    q, k, v = (torch.randn(4, 1500, 6, 64, generator=g, device=card).to(dtype)
               for _ in range(3))
    got = fa_ops.flash_attention_bshd(q, k, v, causal=False)
    want = fa_ref.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), causal=False)
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_refuses_a_head_dim_without_an_instance(card, dtype):
    """hd 96 has no kernel instance: the wrapper raises on the card, with
    no fallback to the plain version."""

    q = torch.zeros(1, 2, 8, 96, dtype=dtype, device=card)
    tracing.reset_counters("launch.")
    with pytest.raises(ValueError, match="head_dim 96"):
        fa_ops.flash_attention_op(q, q, q)
    assert tracing.counter("launch.flash_attention") == 0


def test_flash_attention_bf16_views_tma_cannot_read(card):
    """Views whose strides are not on 16 bytes are copied before the
    kernel reads them by TMA; the result is the same."""

    g = torch.Generator(device=card).manual_seed(3)
    wide = torch.randn(1, 2, 130, 68, generator=g, device=card).bfloat16()
    q = wide[:, :, 1:, :64]  # start and strides off 16 bytes
    k = torch.randn(1, 2, 129, 64, generator=g, device=card).bfloat16()
    v = torch.randn(1, 2, 129, 64, generator=g, device=card).bfloat16()
    got = fa_ops.flash_attention_op(q, k, v, causal=True)
    assert torch.equal(got, fa_ops.flash_attention_op(q.contiguous(), k, v, causal=True))
    torch.testing.assert_close(got.float(), fa_ref.flash_attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("di", [200, 37])  # 37: DI not a multiple of 8 (no 16-byte copies)
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_ssm_scan_every_state_size(card, n, di, xdtype):
    """Each template instance of the scan, DI not a multiple of the
    128-channel block, S not a multiple of the 32-step chunk."""

    rng = np.random.default_rng(n * 100 + di)
    b, s = 2, 70
    delta = torch.from_numpy(np.abs(rng.normal(0, 0.1, (b, s, di))).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, s, di)).astype(np.float32)).to(xdtype)
    A = torch.from_numpy(-np.abs(rng.normal(1, 0.3, (di, n))).astype(np.float32))
    args = [t.to(card) for t in (delta, B, C, x, A)]
    y, h = ssm_ops.ssm_scan_op(*args, block_d=di, chunk=s)
    yr, hr = ssm_ref.ssm_scan_ref(*args)
    torch.testing.assert_close(y.float(), yr.float(), atol=SSM_TOL[xdtype],
                               rtol=SSM_TOL[xdtype])
    torch.testing.assert_close(h, hr, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,di,n,bd,ck", [
    (1, 32, 16, 4, 16, 16),
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 64, 32),
    (3, 96, 48, 8, 16, 32),
    (2, 40, 24, 16, 24, 8),   # DI*N not a multiple of the block
])
def test_ssm_scan_vs_plain(card, b, s, di, n, bd, ck, xdtype):
    rng = np.random.default_rng(s + di)
    delta = torch.from_numpy(np.abs(rng.normal(0, 0.1, (b, s, di))).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, s, di)).astype(np.float32)).to(xdtype)
    A = torch.from_numpy(-np.abs(rng.normal(1, 0.3, (di, n))).astype(np.float32))
    args = [t.to(card) for t in (delta, B, C, x, A)]
    y, h = ssm_ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
    yr, hr = ssm_ref.ssm_scan_ref(*args)
    torch.testing.assert_close(y.float(), yr.float(), atol=SSM_TOL[xdtype],
                               rtol=SSM_TOL[xdtype])
    torch.testing.assert_close(h, hr, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1, 16, 32])
def test_ssm_scan_on_delta_as_the_model_makes_it(card, n, xdtype):
    """delta = softplus(projection + dt_bias) and A = -(1..N), as a Mamba-1
    block makes them, dt_bias from Mamba's dt init (log-uniform in
    [1e-3, 0.1]), over 512 steps: long memories (delta * A near 0) and fast
    decays (delta * A below -1) in one input."""

    rng = np.random.default_rng(n)
    b, s, di, dr = 2, 512, 200, 16
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), di))
    dt_bias = dt + np.log(-np.expm1(-dt))  # softplus^-1(dt)
    proj = rng.normal(size=(b, s, dr)) @ rng.normal(0, 0.25, (dr, di))
    delta = torch.nn.functional.softplus(torch.from_numpy(proj + dt_bias).float())
    B = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, s, di)).astype(np.float32)).to(xdtype)
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous()
    args = [t.to(card) for t in (delta, B, C, x, A)]
    y, h = ssm_ops.ssm_scan_op(*args, block_d=di, chunk=128)
    yr, hr = ssm_ref.ssm_scan_ref(*args)
    torch.testing.assert_close(y.float(), yr.float(), atol=SSM_TOL[xdtype],
                               rtol=SSM_TOL[xdtype])
    torch.testing.assert_close(h, hr, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch,head_dim", [
    ("qwen3-1.7b", None), ("stablelm-3b", None), ("stablelm-3b", 80), ("zamba2-2.7b", None),
    ("zamba2-2.7b", 80), ("falcon-mamba-7b", None), ("moonshot-v1-16b-a3b", None),
    ("grok-1-314b", None), ("internvl2-26b", None), ("whisper-tiny", None),
    ("whisper-tiny", 64)])
def test_serve_smoke_config_goes_through_the_kernel(card, arch, head_dim):
    """One kernel launch a layer of the prefill (a shared-attention
    application of the hybrid: one a group; the encoder-decoder: one an
    encoder layer and one a decoder layer, its cross attention on the torch
    path); ``head_dim`` 80 or 64 replaces the smoke config's 16, as the
    published stablelm-3b and zamba2-2.7b, or whisper-tiny."""

    cfg = get_smoke_config(arch)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    tracing.reset_counters("launch.")
    res = serve(cfg, batch=2, prompt_len=16, gen=4, seed=0, device=card)
    launched = tracing.counter("launch.flash_attention") + tracing.counter("launch.ssm_scan")
    per_prefill = {"hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1),
                   "encdec": cfg.encoder_layers + cfg.n_layers}.get(cfg.family, cfg.n_layers)
    assert launched == per_prefill
    plain = serve(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"),
                  batch=2, prompt_len=16, gen=4, seed=0, device=card)
    torch.testing.assert_close(res["prefill_logits"], plain["prefill_logits"],
                               atol=0.08, rtol=0.08)


# -- the stream kernel ------------------------------------------------------


def _stream_case(card, offs, szs) -> int:
    """Both stream kernels bit-equal to the plain version and the NumPy
    oracle; each wrapper call is one launch.  Returns the rows of one launch
    that took the kernel's exact wide branch."""

    o, s = torch.from_numpy(offs).to(card), torch.from_numpy(szs).to(card)
    rf_kernel.wide_rows(reset=True)
    tracing.reset_counters("launch.")
    rf, _, dist = rf_ops.stream_stats_op(o, s)
    rf_only = rf_ops.stream_rf_op(o, s)
    assert tracing.counters("launch.") == {"launch.stream_stats": 1, "launch.stream_rf": 1}
    rf_p, dist_p = rf_ref.stream_stats_ref(o, s)
    rf_np, _, dist_np = stream_stats_batch_np(offs, szs)
    assert torch.equal(rf, rf_p) and torch.equal(dist, dist_p)
    assert torch.equal(rf_only, rf_p)
    assert np.array_equal(rf.cpu().numpy(), rf_np)
    assert np.array_equal(dist.cpu().numpy(), dist_np)
    return rf_kernel.wide_rows(reset=True) // 2


@pytest.mark.parametrize("kind", stream_rows.KINDS)
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_stream_kernel_row_kinds(card, n, kind):
    """Every width the kernel takes, on ties of differing sizes, int64
    wrap, negative and extreme offsets, bucket collisions, rows that take
    the wide branch and both kinds in one launch; 37 and 300 rows (sentinel
    rows in the last warp)."""

    rng = np.random.default_rng(n + 1000 * stream_rows.KINDS.index(kind))
    for m in (37, 300):
        wide = _stream_case(card, *stream_rows.stream_rows(kind, m, n, rng))
        if kind == "outlier" and n >= 16:
            assert wide == m  # a reversed run in one bucket: the wide branch
        if kind in ("random40", "ties", "contiguous", "collide"):
            assert wide == 0  # collisions are put right in place


def test_stream_kernel_on_the_sweeps_one_launch_matrix(card):
    """The matrix the fleet sweep launches: every shard's padded streams,
    concatenated, and the per-shard scores it gives equal the CPU's."""

    batch = sweep_trace()
    nodes = 64
    shards = batch.shard(assign_nodes("range-offset", batch.offsets, batch.file_ids,
                                      batch.app_ids, nodes), nodes)
    offs = np.concatenate([s.padded_stream_matrix()[0] for s in shards])
    szs = np.concatenate([s.padded_stream_matrix()[1] for s in shards])
    _stream_case(card, offs, szs)
    tracing.reset_counters("launch.")
    got = _score_shards_kernel(shards, 128, card)
    assert tracing.counter("launch.stream_stats") == 1
    want = _score_shards_kernel(shards, 128, torch.device("cpu"))
    for g, w in zip(got, want):
        for f in ("rf_sum", "percentage", "seek_distance", "nbytes", "offset_sum"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f


def test_stream_kernel_on_views_8_bytes_off(card):
    """Inputs whose data is not 16-byte aligned (the kernel's copy unit)."""

    offs, szs = stream_rows.stream_rows("random40", 37, 128, np.random.default_rng(5))
    flat_o = torch.zeros(offs.size + 1, dtype=torch.int64, device=card)
    flat_s = torch.zeros(szs.size + 1, dtype=torch.int64, device=card)
    o = flat_o[1:].view(offs.shape).copy_(torch.from_numpy(offs))
    s = flat_s[1:].view(szs.shape).copy_(torch.from_numpy(szs))
    assert o.data_ptr() % 16 == 8
    rf, _, dist = rf_ops.stream_stats_op(o, s)
    rf_np, _, dist_np = stream_stats_batch_np(offs, szs)
    assert np.array_equal(rf.cpu().numpy(), rf_np)
    assert np.array_equal(dist.cpu().numpy(), dist_np)


@pytest.mark.parametrize("kind", stream_rows.KINDS)
@pytest.mark.parametrize("n", [3, 17, 96, 1000, 1025, 2048, 4096, 8192])
def test_stream_kernel_any_width_and_true_lengths(card, n, kind):
    """Widths that are not powers of two (the padded branch) and above 1024
    (the long-row kernel), on every row kind, with and without per-row true
    lengths: bit-equal to the plain version and to the NumPy oracle on each
    row's real requests; the long-row kernel's exact branch takes exactly
    the rows ``long_row_exact`` predicts."""

    rng = np.random.default_rng(n + 77 * stream_rows.KINDS.index(kind))
    m = 37 if n <= 1024 else 5
    offs, szs = stream_rows.stream_rows(kind, m, n, rng)
    if n & (n - 1):
        _stream_case(card, offs, szs)
    lens = rng.integers(0, n + 1, size=m)
    lens[:3] = (0, 1, n)
    o, s = torch.from_numpy(offs).to(card), torch.from_numpy(szs).to(card)
    ln = torch.from_numpy(lens).to(card)
    rf_kernel.long_rows(reset=True)
    rf_kernel.long_wide_rows(reset=True)
    rf, pct, dist = rf_ops.stream_stats_op(o, s, ln)
    rf_p, dist_p = rf_ref.stream_stats_ref(o, s, ln)
    assert torch.equal(rf, rf_p) and torch.equal(dist, dist_p)
    want = [stream_stats_batch_np(offs[i:i + 1, :k], szs[i:i + 1, :k]) for i, k in enumerate(lens)]
    assert np.array_equal(rf.cpu().numpy(), [w[0][0] for w in want])
    assert np.array_equal(dist.cpu().numpy(), [w[2][0] for w in want])
    assert rf_kernel.long_rows(reset=True) == (m if n > 1024 else 0)
    # the long-row kernel's exact branch takes the rows it cannot repair
    exact = int(stream_rows.long_row_exact(offs, lens).sum()) if n > 1024 else 0
    assert rf_kernel.long_wide_rows(reset=True) == exact


def test_stream_kernel_refuses_above_its_limit(card):
    n = rf_ops.MAX_STREAM_LEN + 1
    z = torch.zeros(2, n, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="numpy"):
        rf_ops.stream_stats_op(z, z)


@pytest.mark.parametrize("workload", ["mixed-burst", "strided-gaps"])
def test_ftl_sweep_card_equals_cpu(card, workload):
    """FleetProgram(ssd="ftl") at 4 MiB a node (GC fires): integer fields
    exact, clocks within 1e-9 relative, card against CPU."""

    batch = golden_trace(workload)
    kw = dict(num_nodes=4, policy="range-offset", ssd_capacity=4 << 20, ssd="ftl")
    got = FleetProgram(device=card, **kw).run(batch)
    want = FleetProgram(device="cpu", **kw).run(batch)
    for scheme in want:
        for g, w in zip(fleet_result_to_dict(got[scheme])["nodes"],
                        fleet_result_to_dict(want[scheme])["nodes"]):
            for k, v in w.items():
                if isinstance(v, float):
                    assert g[k] == pytest.approx(v, rel=1e-9, abs=0), (scheme, k)
                else:
                    assert g[k] == v, (scheme, k)


def test_golden_fixture_sanitized_on_card(card):
    """One golden fixture's configuration through FleetProgram on the card
    under sanitizing(): every field equal to the unsanitized card run, and
    within the fixture's device_tolerance."""

    payload = golden.load_fixture(golden.fixture_path("ssdup+", "mixed-burst", "range-offset"))
    batch = golden_trace("mixed-burst")
    kw = dict(num_nodes=golden.FIXTURE_NODES, schemes=("ssdup+",), policy="range-offset",
              ssd_capacity=payload["key"]["ssd_capacity"], device=card)
    plain = FleetProgram(**kw).run(batch)["ssdup+"]
    with sanitizing():
        checked = FleetProgram(**kw).run(batch)["ssdup+"]
    assert fleet_result_to_dict(checked) == fleet_result_to_dict(plain)
    assert golden.check_fixture(payload, checked, tolerances=payload["device_tolerance"]) == []


def _replay_on_card(card, events, lanes, state0) -> dict:
    """The replay kernel against its plain torch version on the card
    (integer fields exact, clocks within 1e-9 relative, NaN where it is)
    and against the CPU run (the same gates); one launch."""

    p, g, steps = ed.replay_inputs(events, lanes, state0, device=card)
    tracing.reset_counters("launch.")
    got = replay_ops.replay_op(p, g, steps)
    assert tracing.counter("launch.replay") == 1
    plain = replay_ops.plain(p, g, steps)
    cpu = ed.replay_lanes(events, lanes, state0, device="cpu")
    for k, v in got.items():
        for want in (plain[k].cpu(), torch.from_numpy(cpu[k])):
            if v.dtype.is_floating_point:
                torch.testing.assert_close(v.cpu(), want, rtol=1e-9, atol=0,
                                           equal_nan=True, msg=k)
            else:
                assert v.dtype == want.dtype and torch.equal(v.cpu(), want), k
    return {k: v.cpu().numpy() for k, v in got.items()}


@pytest.mark.parametrize("ssd", [None, "ftl"])
@pytest.mark.parametrize("workload", ["mixed-burst", "strided-gaps"])
def test_replay_kernel_vs_plain_on_golden_program(card, workload, ssd):
    batch = golden_trace(workload)
    prog = FleetProgram(num_nodes=golden.FIXTURE_NODES, schemes=golden.FIXTURE_SCHEMES,
                        policy="range-offset", ssd=ssd,
                        ssd_capacity=golden._node_capacity(batch.total_bytes), device=card)
    _replay_on_card(card, *prog._lane_inputs(batch)[:3])
    tracing.reset_counters("launch.")
    prog.run(batch)
    assert tracing.counter("launch.replay") == 1


def test_the_replay_kernel_lies_inside_its_span_on_the_profilers_clock(card):
    """Under the profiler, the replay kernel's interval from the profiler's
    raw events, moved onto the tracer's clock by the sweep's offset, lies
    between the ``replay`` span's start and the end of its ``wait`` (the
    status read-back); the spans add no device rows."""

    batch = golden_trace("mixed-burst")
    prog = FleetProgram(num_nodes=golden.FIXTURE_NODES, schemes=golden.FIXTURE_SCHEMES,
                        policy="range-offset",
                        ssd_capacity=golden._node_capacity(batch.total_bytes), device=card)
    prog.run(batch)
    torch.cuda.synchronize()
    tracing.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prog.run(batch)
        torch.cuda.synchronize()
    spans = tracing.take()
    kernels = [iv for iv, e in zip(tracing.device_intervals(prof), sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == torch.autograd.DeviceType.CUDA),
        key=lambda e: (e.start_ns(), e.end_ns()))) if "replay_kernel" in e.name()]
    assert len(kernels) == 1
    (sweep,) = [s for s in spans if s.name == "sweep"]
    (replay,) = [s for s in spans if s.name == "replay"]
    (wait,) = [s for s in spans if s.name == "wait" and s.parent == replay.id]
    off = sweep.clock_offset_ns
    k0, k1 = kernels[0]
    print(f"clock offset {off} ns; kernel {k1 - k0} ns, starts "
          f"{k0 - (replay.t0_ns + off)} ns after the replay span opens, ends "
          f"{wait.t1_ns + off - k1} ns before its wait closes")
    assert replay.t0_ns + off <= k0 < k1 <= wait.t1_ns + off
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"sweep", "shard", "score", "tapes", "stack", "pack", "replay",
                        "readback", "results", "wait"}


@pytest.mark.parametrize("field", ["net_t", "hddt_0"])
def test_replay_kernel_carries_a_seeded_nan(card, field):
    batch = golden_trace("mixed-burst")
    tape = ed.build_events(batch, compute_stream_scores(batch, device="cpu"))
    tape[field][0] = np.nan
    out = _replay_on_card(card, ed.stack_events([tape]),
                          ed._stack_lanes([ed.lane_consts("ssdup+", 1 << 26)]),
                          ed._stack_lanes([ed.initial_lane_state("ssdup+", 64)]))
    assert np.isnan(out["io_seconds"][0])


def test_replay_kernel_on_a_wrapping_window(card):
    """A sweep long enough that every lane's window of 7 wraps, the device
    gate, a region small enough to swap and block."""

    batch = sweep_trace(150_000)
    prog = FleetProgram(num_nodes=4, policy="range-offset", ssd_capacity=32 << 20,
                        flush_gate="device", adaptive_window=7, device=card)
    _replay_on_card(card, *prog._lane_inputs(batch)[:3])


@pytest.mark.parametrize("window,warm", [(1, 0), (64, 40), (1024, 0), (1024, 1500)])
def test_replay_kernel_at_each_window_size(card, window, warm):
    """SSDUP+'s threshold pass on the card at windows of 1, 64 and 1,024
    slots (the largest: one chunk of 1,024 events), empty, warmed up in
    part and full, over tapes of about 300 events a lane (ten ring stages,
    several chunks at the smaller windows)."""

    batch = sweep_trace(150_000)
    warmup = list(compute_stream_scores(batch, device="cpu").percentage[:warm]) or None
    prog = FleetProgram(num_nodes=4, policy="range-offset", ssd_capacity=32 << 20,
                        adaptive_window=window, threshold_warmup=warmup, device=card)
    _replay_on_card(card, *prog._lane_inputs(batch)[:3])


@pytest.mark.parametrize("case", [c for c in tapes_cases.CASES if c != "empty"])
def test_tapes_kernel_equals_numpy_columns(card, case):
    """Every column of the tapes kernel bit for bit equal to the host tape
    builder's NumPy columns, one launch a shard."""

    shards, stream_len = tapes_cases.tape_case(case)
    for batch in shards:
        tracing.reset_counters("launch.")
        cols = tapes_cases.shard_cols(batch).to(card)
        got = tapes_ops.columns_op(cols, stream_len, tapes_cases.CONSTS)
        assert tracing.counter("launch.tapes") == 1
        want = tapes_cases.numpy_columns(batch, stream_len)
        assert tapes_cases.same_bits(got.cpu().numpy(), want) == []


def test_tapes_on_card_in_a_fresh_sweep(card):
    """A fresh sweep of the paper's random IOR run on its 2 I/O nodes: one
    tapes launch a shard on the cache's miss, none on its hit, tapes
    bit-equal to the NumPy path's, and the sweep's peak device memory no
    higher than the replay's packed inputs (1,224,704 B) with one shard's
    tapes inputs held at a time."""

    batch = tapes_cases.ior_trace("segmented-random")

    def program(device):
        return FleetProgram(num_nodes=tapes_cases.IOR_NODES, policy="range-offset",
                            stream_len=128, adaptive_window=64, device=device)

    program(card).run(batch)  # builds and loads every kernel
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    tracing.reset_counters()
    prog = program(card)
    prog.run(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    print(f"peak over the sweep {peak} B; counters {tracing.counters()}")
    assert peak <= 1_224_704
    assert tracing.counter("launch.tapes") == tapes_cases.IOR_NODES
    assert tracing.counters("tapes.") == {}
    tracing.reset_counters()
    prog.run(batch)
    assert tracing.counter("tape_cache.hit") == 1 and tracing.counter("launch.tapes") == 0
    cpu = program("cpu")
    cpu.run(batch)
    for got, want in zip(prog._tape_cache[1], cpu._tape_cache[1]):
        assert tapes_cases.same_tape(got, want) == []


def test_tapes_above_the_kernels_limit_take_the_host_path(card):
    batch = golden_trace("mixed-burst")
    stream_len = tapes_ops.MAX_STREAM_LEN + 1
    scores = compute_stream_scores(batch, stream_len, backend="numpy")
    tracing.reset_counters()
    got = ed.build_events(batch, scores, stream_len=stream_len, device=card)
    assert tracing.counter("tapes.host") == 1 and tracing.counter("launch.tapes") == 0
    want = ed.build_events(batch, scores, stream_len=stream_len)
    assert tapes_cases.same_tape(got, want) == []


SERVICE_FAULTS = {
    "healthy": None,
    "crash": lambda: FaultInjector.crash_at(2.5, 2),
    "every-kind": lambda: scripted((1.0, "crash", 5), (2.0, "slow", 2, 3.0),
                                   (2.0, "ssd_degrade", 6, 0.5), (1.5, "stall", 1, 1.0, 6.0)),
}


@pytest.mark.parametrize("scenario", sorted(SERVICE_FAULTS))
def test_service_on_card_equals_numpy_scoring(card, scenario):
    """BurstBufferService on the card: its windows scored by the stream
    kernel in one launch a run plus one a resharding failover, and the
    result equal, field for field, to the same run scored by the NumPy
    oracle."""

    batch = poisson_arrivals(golden_trace("mixed-burst"), rate_rps=100.0, seed=7)  # ~10 s
    make = SERVICE_FAULTS[scenario]
    kw = dict(num_nodes=8, policy="range-offset", ssd_capacity=16 << 20, epoch_seconds=0.5,
              heartbeat_timeout=2.0)
    if scenario == "every-kind":
        kw.update(ssd="ftl", admission_occupancy=0.9)
    svc = ReshardCountingService(injector=make and make(), device=card, **kw)
    tracing.reset_counters("launch.")
    got = svc.run(batch)
    assert tracing.counter("launch.stream_stats") == 1 + svc.reshards
    assert (svc.reshards > 0) == (scenario != "healthy")
    want = BurstBufferService(injector=make and make(), score_backend="numpy", device=card,
                              **kw).run(batch)
    assert same_service_result(got, want)
    assert got.metrics.conservation_violations() == []


# -- training -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_train_steps_on_card_equal_cpu(card, arch):
    """Three train steps of the smoke config in f32 (TF32 off) on the card
    and on the CPU, from the same weights and batches: loss and grad_norm
    within rtol 1e-5, every parameter within atol 2e-5 / rtol 1e-4 (the
    embedding backward accumulates atomically on the card, and the two
    devices sum in other orders)."""

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attention_impl="torch",
                              ssm_impl="torch")
    opt = AdamWConfig(lr=1e-3, schedule=linear_warmup_cosine(1, 3))
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4), 0)
    cpu_params = get_model(cfg, "cpu").init_params(0)
    runs = {}
    for dev in ("cpu", card):
        params = copy.deepcopy(cpu_params).to(dev)
        state = init_state(dict(params.named_parameters()))
        step = make_train_step(get_model(cfg, dev), opt)
        metrics = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in loader.get(i).items()}
            params, state, m = step(params, state, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        runs[str(dev)] = params, metrics
    (p_cpu, m_cpu), (p_card, m_card) = runs["cpu"], runs[str(card)]
    for a, b in zip(m_cpu, m_card):
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
    for (name, a), b in zip(p_cpu.named_parameters(), p_card.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=2e-5, rtol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_bf16_checkpoint_round_trip_on_card(card, arch, tmp_path):
    """bf16 parameters on the card through ``save_async`` (a device-to-host
    snapshot, isolated from the in-place change that follows) and back:
    bit-equal, and the kernel prefill of the restored parameters gives the
    live ones' logits bit for bit."""

    cfg = get_smoke_config(arch)
    model = get_model(cfg, card)
    params = model.init_params(0)
    want = copy.deepcopy(params)
    ck = Checkpointer(TieredCheckpointStore(str(tmp_path)))
    ck.save_async(1, {"params": tree_from_params(params)})
    with torch.no_grad():
        for t in params.parameters():
            t.add_(1.0)
    ck.wait()
    step, tree = ck.restore_latest(like={"params": tree_from_params(want)})
    ck.close()
    assert step == 1 and tree["params"]["tok_emb"].dtype == torch.bfloat16
    restored = params_from_jax(cfg, tree["params"], device=card)
    for (name, a), b in zip(want.named_parameters(), restored.parameters()):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    tracing.reset_counters("launch.")
    with torch.inference_mode():
        live, _ = model.prefill(want, {"tokens": toks})
        back, _ = model.prefill(restored, {"tokens": toks})
    assert tracing.counter("launch.flash_attention") + tracing.counter("launch.ssm_scan") == 2 * cfg.n_layers
    assert torch.equal(live, back)


def _nccl_mesh_steps(arch: str) -> dict:
    """Runs in a spawned child: the smoke config's sharded steps on a
    one-rank NCCL (1, 1) mesh on the card and its plain steps, both whole on
    the CPU, and the prefill's kernel launches on the mesh."""

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.testing.sharded import sharded_steps

    cfg = get_smoke_config(arch)
    dev = torch.device("cuda")
    tree = tree_from_params(get_model(cfg, dev).init_params(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    plain = sharded_steps(cfg, tree, batch, None, device=dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        tracing.reset_counters("launch.")
        sharded = sharded_steps(cfg, tree, batch, mesh, device=dev)
        launches = tracing.counter("launch.flash_attention")
    finally:
        dist.destroy_process_group()
    return {"plain": plain, "sharded": sharded, "launches": launches, "layers": cfg.n_layers}


def test_sharded_steps_on_a_one_rank_nccl_mesh(card, tmp_path):
    """The mesh phase of ``chip_smoke.py`` at smoke size: on a (1, 1) mesh
    nothing is split, so the sharded train step, prefill (the kernel through
    ``local_map``, once a layer) and decode steps give the plain steps'
    results, but for the sharded cross entropy's and split-KV softmax's
    f32 rounding: a gradient whose sign rounds otherwise moves its weight by
    2 lr in Adam's first step (and an ulp more in bf16: 4 lr), the logits
    within the serve tolerance."""

    from repro_torch.testing.sharded import spawn_world

    out = spawn_world(1, str(tmp_path), _nccl_mesh_steps, "qwen3-1.7b", group=False)[0]
    plain, sharded = out["plain"], out["sharded"]
    assert out["launches"] == out["layers"]
    assert float(plain["loss"]) == pytest.approx(float(sharded["loss"]), rel=1e-3)
    for k, v in plain["params"].items():
        torch.testing.assert_close(sharded["params"][k], v, atol=4e-3, rtol=1.6e-2)  # lr 1e-3
    torch.testing.assert_close(sharded["prefill_logits"], plain["prefill_logits"],
                               atol=0.1, rtol=1.6e-2)
    for a, b in zip(sharded["decode_logits"], plain["decode_logits"], strict=True):
        torch.testing.assert_close(a, b, atol=0.1, rtol=1.6e-2)


def _dry_run_both(out_dir: str) -> dict:
    """Runs in a spawned child: a smoke-size dry-run cell on the card and
    on the CPU."""

    from repro_torch.launch import dryrun

    cfg = get_smoke_config("qwen3-1.7b")
    return {dev: dryrun.run_cell("qwen3-1.7b", "train_4k", "single", f"{out_dir}/{dev}",
                                 override_cfg=cfg, device=dev) for dev in ("cuda", "cpu")}


def test_dry_run_on_the_card_counts_what_the_cpu_counts(card, tmp_path):
    from repro_torch.testing.sharded import spawn_world

    recs = spawn_world(1, str(tmp_path), _dry_run_both, str(tmp_path), group=False)[0]
    cuda, cpu = recs["cuda"], recs["cpu"]
    assert cuda["memory"]["peak_allocated_bytes"] > cuda["memory"]["argument_bytes"] > 0
    assert cuda["memory"]["argument_bytes"] == cpu["memory"]["argument_bytes"]
    assert cuda["roofline"]["flops_per_device"] == cpu["roofline"]["flops_per_device"]
    assert cuda["collectives"] == cpu["collectives"]
    assert cuda["step_s"] > 0 and cpu["step_s"] is None
