"""The port's tracer (``repro_torch.tracing``) on the CPU, at small shapes:
spans only while a profiler records, the fleet sweep's span tree, the
counters of host waits and copied bytes against the counts the shapes
give, the tape cache, the idle time laid over spans, and the benchmark's
metric files that read the spans."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import FleetProgram
from repro_torch.kernels.replay import ops as replay_ops
from repro_torch.kernels.replay.ref import OUTPUTS
from repro_torch.testing import golden
from repro_torch.testing.traces import golden_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench.harness import registry  # noqa: E402
from bench.harness.probes import Recorder  # noqa: E402
from bench.harness.readings import Window  # noqa: E402

TREE = ("shard", "score", "tapes", "stack", "pack", "replay", "readback", "results")
METRICS = ("shard_span_ms", "score_span_ms", "tapes_span_ms", "stack_span_ms",
           "results_span_ms", "device_wait_ms", "sweep_cpu_ms", "host_syncs", "copy_kib")
FRESH_ONLY = ("shard_span_ms", "score_span_ms", "tapes_span_ms")


@pytest.fixture(autouse=True)
def clean():
    tracing.take()
    tracing.reset_counters()
    yield
    tracing.take()
    tracing.reset_counters()


def _program(batch) -> FleetProgram:
    return FleetProgram(num_nodes=golden.FIXTURE_NODES, schemes=golden.FIXTURE_SCHEMES,
                        policy="range-offset",
                        ssd_capacity=golden._node_capacity(batch.total_bytes), device="cpu")


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()


def _shape_counts(prog: FleetProgram, batch) -> dict:
    """What a sweep copies and reads back, from its shapes alone."""

    shards = prog.shard(batch)
    rows = sum(-(-s.num_requests // prog.stream_len) for s in shards)
    events, lanes, state0, _ = prog._lane_inputs(batch)
    s, l = events["valid"].shape
    w = state0["win"].shape[1]
    packed = sum(dt.itemsize * int(np.prod(shape))
                 for _, dt, shape, _ in replay_ops._sections(replay_ops.padded_len(s), l, w))
    outs = sum(l * (4 if k == "flushes" else 8) for k in OUTPUTS)
    return {"score_h2d": 2 * rows * prog.stream_len * 8, "score_d2h": 2 * rows * 8,
            "replay_h2d": packed, "replay_d2h": 1 + outs}


@pytest.fixture(scope="module")
def fresh():
    """Two sweeps of one trace, each through a new program, under the
    profiler: their spans and counters."""

    tracing.take()
    tracing.reset_counters()
    batch = golden_trace("mixed-burst")
    _profiled(lambda: [_program(batch).run(batch) for _ in range(2)])
    out = {"spans": tracing.take(), "counters": tracing.counters(),
           "shapes": _shape_counts(_program(batch), batch)}
    tracing.reset_counters()
    return out


@pytest.fixture(scope="module")
def resweep():
    """One program swept once off the profiler (filling its tape cache),
    then twice under it."""

    tracing.take()
    batch = golden_trace("mixed-burst")
    prog = _program(batch)
    prog.run(batch)
    tracing.reset_counters()
    _profiled(lambda: [prog.run(batch) for _ in range(2)])
    out = {"spans": tracing.take(), "counters": tracing.counters(),
           "shapes": _shape_counts(prog, batch)}
    tracing.reset_counters()
    return out


def test_no_profiler_no_spans():
    batch = golden_trace("strided-gaps")
    _program(batch).run(batch)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.records() == []
    assert tracing.counter("host_syncs") == 12


def test_span_is_a_shared_no_op_without_the_profiler():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a") as s:
        assert s is None


def test_the_sweep_span_tree(fresh, resweep):
    for run, names in ((fresh, TREE), (resweep, TREE[3:])):
        spans = run["spans"]
        roots = [s for s in spans if s.parent is None]
        assert [s.name for s in roots] == ["sweep", "sweep"]
        for root in roots:
            group = [s for s in spans if s.sweep == root.id]
            top = [s for s in group if s.parent == root.id]
            assert tuple(s.name for s in sorted(top, key=lambda s: s.t0_ns)) == names
            by_id = {s.id: s for s in group}
            for s in group:
                assert s.t0_ns <= s.t1_ns
                if s.name == "wait":
                    assert by_id[s.parent].name in ("score", "replay", "readback")
                elif s is not root:
                    assert s.parent == root.id
                    p = by_id[s.parent]
                    assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            waits = [by_id[s.parent].name for s in group if s.name == "wait"]
            assert sorted(waits) == sorted(["score"] * (names == TREE) + ["replay"]
                                           + ["readback"] * len(OUTPUTS))
            assert root.clock_offset_ns is not None and root.cpu_ns >= 0
            assert all(s.clock_offset_ns is None and s.cpu_ns is None
                       for s in group if s is not root)


@pytest.mark.parametrize("kind", ["fresh", "resweep"])
def test_a_sweep_counts_what_its_shapes_give(kind, fresh, resweep):
    run = {"fresh": fresh, "resweep": resweep}[kind]
    sh = run["shapes"]
    new = kind == "fresh"
    want = {"host_syncs": 12 if new else 11,
            "h2d_bytes": sh["replay_h2d"] + new * sh["score_h2d"],
            "d2h_bytes": sh["replay_d2h"] + new * sh["score_d2h"]}
    sweeps = [s for s in run["spans"] if s.name == "sweep"]
    for s in sweeps:
        assert {k: s.counts.get(k, 0) for k in want} == want
    assert {k: run["counters"][k] for k in want} == {k: 2 * v for k, v in want.items()}
    by_name = {s.name: s.counts for s in run["spans"] if s.sweep == sweeps[0].id}
    assert by_name["pack"] == {"h2d_bytes": sh["replay_h2d"]}
    assert by_name["replay"] == {"host_syncs": 1, "d2h_bytes": 1}
    assert by_name["readback"] == {"host_syncs": len(OUTPUTS),
                                   "d2h_bytes": sh["replay_d2h"] - 1}
    if new:
        assert by_name["score"] == {"h2d_bytes": sh["score_h2d"], "host_syncs": 1,
                                    "d2h_bytes": sh["score_d2h"]}


def test_tape_cache_misses_then_hits():
    batch = golden_trace("strided-gaps")
    prog = _program(batch)
    prog.run(batch)
    assert tracing.counters("tape_cache") == {"tape_cache.miss": 1}
    prog.run(batch)
    assert tracing.counters("tape_cache") == {"tape_cache.miss": 1, "tape_cache.hit": 1}


def test_counters_reset_by_prefix():
    tracing.count("launch.a")
    tracing.count("launch.b", 3)
    tracing.count("other")
    assert tracing.counters("launch.") == {"launch.a": 1, "launch.b": 3}
    tracing.reset_counters("launch.")
    assert tracing.counters() == {"other": 1} and tracing.counter("launch.b") == 0


def test_summary_is_each_layers_share_of_a_sweep(fresh):
    summ = tracing.summary(fresh["spans"])
    assert set(summ) == {"sweep", "wait", *TREE}
    assert summ["sweep"]["count"] == 1 and summ["wait"]["count"] == 2 + len(OUTPUTS)
    assert summ["sweep"]["counts"]["host_syncs"] == 12
    inside = sum(summ[k]["wall_ms"] for k in TREE)
    assert summ["sweep"]["self_ms"] == pytest.approx(summ["sweep"]["wall_ms"] - inside)
    for name, row in summ.items():
        assert 0 <= row["self_ms"] <= row["wall_ms"]
        assert (row["cpu_ms"] is None) == (name != "sweep")
    assert summ["sweep"]["cpu_ms"] >= 0


def _span(name, t0, t1, parent=None, offset=0):
    """A closed span at given times on the tracer's clock."""

    s = tracing.Span(name, parent)
    s.t0_ns, s.t1_ns = t0, t1
    if parent is None:
        s.clock_offset_ns = offset
    return s


def test_idle_by_span_on_synthetic_intervals():
    off = 1_000_000
    root = _span("sweep", 0, 100, offset=off)
    a = _span("tapes", 10, 40, root)
    w = _span("wait", 20, 30, a)
    b = _span("replay", 50, 90, root)
    other = _span("sweep", 200, 300, offset=off + 7)
    # busy on the profiler's clock: 25-35 (inside the wait, then tapes),
    # 60-70 and 65-80 overlapping (inside replay), 5-15 (sweep, then tapes)
    busy = [(off + 25, off + 35), (off + 60, off + 70), (off + 65, off + 80),
            (off + 5, off + 15)]
    idle = tracing.idle_by_span(busy, [root, a, w, b, other])
    assert idle[root.id] == {"sweep": 5 + 10 + 10, "tapes": 5 + 5, "wait": 5,
                             "replay": 10 + 10}
    assert sum(idle[root.id].values()) == 100 - 10 - 20 - 10
    assert idle[other.id] == {"sweep": 100}


def test_idle_by_span_with_the_device_always_busy():
    root = _span("sweep", 0, 100, offset=0)
    child = _span("stack", 0, 100, root)
    assert tracing.idle_by_span([(-5, 200)], [root, child]) == {root.id: {}}
    assert tracing.idle_by_span([], [root, child]) == {root.id: {"stack": 100}}


def _window(spans) -> Window:
    n = sum(s.name == "sweep" for s in spans)
    return Window(Recorder(lambda: None), [0.01] * n, None, None, 0.01 * n)


@pytest.mark.parametrize("kind", ["fresh", "resweep"])
@pytest.mark.parametrize("metric", METRICS)
def test_each_metric_file_reads_a_traced_window(metric, kind, fresh, resweep, monkeypatch):
    run = {"fresh": fresh, "resweep": resweep}[kind]
    spans = run["spans"]
    mod = registry.load_module(REPO / "bench" / "metrics" / f"{metric}.py")
    monkeypatch.setattr(tracing, "records", lambda: list(spans))
    got = mod.read(_window(spans))
    entry = next(m for m in registry.benchmark()["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and mod.UNIT == entry["unit"]
    if kind == "resweep" and metric in FRESH_ONLY:
        assert got is None
        return
    sweeps = [s for s in spans if s.name == "sweep"]
    names = {"shard_span_ms": ("shard",), "score_span_ms": ("score",),
             "tapes_span_ms": ("tapes",), "stack_span_ms": ("stack", "pack"),
             "results_span_ms": ("readback", "results"), "device_wait_ms": ("wait",)}
    sh = run["shapes"]
    new = kind == "fresh"
    want = {
        "sweep_cpu_ms": sum(s.cpu_ns for s in sweeps) / 1e6 / 2,
        "host_syncs": 12 if new else 11,
        "copy_kib": (sh["replay_h2d"] + sh["replay_d2h"]
                     + new * (sh["score_h2d"] + sh["score_d2h"])) / 1024,
    }.get(metric)
    if want is None:
        want = sum(s.wall_ns for s in spans if s.name in names[metric]) / 1e6 / 2
    assert got == pytest.approx(want) and got > 0
    # a window whose sweeps the records do not match reads nothing
    assert mod.read(Window(Recorder(lambda: None), [0.01] * 3, None, None, 0.03)) is None


def test_metric_files_read_nothing_without_the_tracer(fresh, monkeypatch):
    """A program without the tracer (an older checkout): every reader
    returns ``None`` and raises nothing."""

    import repro_torch

    spans = fresh["spans"]
    monkeypatch.setattr(tracing, "records", lambda: list(spans))
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for metric in METRICS:
        mod = registry.load_module(REPO / "bench" / "metrics" / f"{metric}.py")
        assert mod.read(_window(spans)) is None
