"""The port's online service (``repro_torch.service``) against the
reference's (``repro.service``) on the same seeded loads, at the
reference tests' size (128 MiB apps, 4 nodes with 64 MiB of SSD each).

Tolerance 0 throughout: every scenario gives the reference's per-node
``SimResult``\\ s, every ``ServiceMetrics`` field, every fault record and
the latency array, bit for bit.  The port runs with ``device="cpu"``, so
its windows are scored by the stream kernel's plain version (one call a
run, one more a failover that reshards pending windows); the reference
scores each window on the host.  The no-fault service also equals the
port's own ``FleetSimulator``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.service as RS
from repro.core.trace import Gap as RGap
import repro_torch.core as P
import repro_torch.service as PS
from repro_torch.core.random_factor import stream_stats_batch_np
from repro_torch.core.trace import Gap as PGap
from repro_torch.core.workloads import MiB
from repro_torch.service import loop as port_loop
from repro_torch.testing.service import (ReshardCountingService, same_service_result,
                                         service_result_to_dict)

SCHEMES = ["orangefs", "orangefs-bb", "ssdup", "ssdup+"]
SMALL = 128 * MiB
SIDES = {"ref": (R, RS, RGap), "port": (P, PS, PGap)}


def _apps(core, total=SMALL):
    return [
        core.relabel(core.ior("segmented-contiguous", 8, total_bytes=total, seed=1),
                     app_id=0, file_id=0),
        core.relabel(core.ior("segmented-random", 8, total_bytes=total, seed=2),
                     app_id=1, file_id=1),
        core.relabel(core.ior("strided", 16, total_bytes=total, seed=3),
                     app_id=2, file_id=2),
    ]


def _offered(side):
    """Poisson-stamped mixed load with compute gaps in the middle (the
    reference tests' ``offered``)."""

    core, svc, gap = SIDES[side]
    items = list(core.mixed(*_apps(core), burst_requests=256).trace)
    items.insert(400, gap(3.0))
    items.insert(900, gap(2.0))
    return svc.poisson_arrivals(core.TraceBatch.from_items(items), rate_rps=2000.0, seed=11)


def _sustained(side):
    """All-random traffic at 300 req/s on 8 apps (the reference tests'
    ``sustained``): enough window samples for the straggler rule."""

    core, svc, _ = SIDES[side]
    apps = [core.ior("segmented-random", 8, total_bytes=256 * MiB, seed=i, app_id=i,
                     file_id=i) for i in range(8)]
    batch = core.TraceBatch.from_items(core.mixed(*apps, burst_requests=64, seed=9).trace)
    return svc.poisson_arrivals(batch, rate_rps=300.0, seed=2)


LOADS = {"offered": _offered, "sustained": _sustained}


@pytest.fixture(scope="module")
def loads():
    return {(name, side): make(side) for name, make in LOADS.items() for side in SIDES}


def assert_same_result(got, want):
    """Port ``ServiceResult`` == reference ``ServiceResult``, field for
    field: node results, every metrics field and fault record, latencies."""

    a, b = service_result_to_dict(got), service_result_to_dict(want)
    assert np.array_equal(a.pop("latencies"), b.pop("latencies"))
    for key in b:
        assert a[key] == b[key], key
    for prop in ("p50_latency", "p99_latency", "p999_latency", "throughput_mbs",
                 "healthy_throughput_mbs", "degraded_throughput_mbs", "recovery_seconds"):
        assert getattr(got.metrics, prop) == getattr(want.metrics, prop), prop
    assert got.metrics.conservation_violations() == want.metrics.conservation_violations()
    assert got.fleet.total_bytes == want.fleet.total_bytes


def _injector(svc, events):
    return svc.scripted(*events) if events else None


def run_both(loads, load, events=(), **kw):
    """The same scenario through the reference and the port (``device="cpu"``)."""

    want = RS.BurstBufferService(injector=_injector(RS, events), **kw).run(loads[load, "ref"])
    got = PS.BurstBufferService(injector=_injector(PS, events), device="cpu",
                                **kw).run(loads[load, "port"])
    assert_same_result(got, want)
    return got


# ---------------------------------------------------------------------------
# the loads themselves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("load", sorted(LOADS))
def test_offered_loads_equal_reference(loads, load):
    a, b = loads[load, "port"], loads[load, "ref"]
    for col in ("offsets", "sizes", "file_ids", "app_ids", "times", "gap_positions",
                "gap_seconds"):
        assert np.array_equal(getattr(a, col), getattr(b, col)), col


# ---------------------------------------------------------------------------
# no faults: the reference, and the port's own offline fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_healthy_equals_reference_and_fleet_simulator(loads, scheme, ssd):
    kw = dict(scheme=scheme, num_nodes=4, policy="round-robin-app", ssd_capacity=64 * MiB)
    if ssd == "ftl":
        kw["ssd"] = "ftl"
    got = run_both(loads, "offered", **kw)
    off = P.FleetSimulator(device="cpu", **kw).run(loads["offered", "port"])
    assert got.node_results == off.node_results
    m = got.metrics
    assert m.conservation_violations() == [] and m.faults == []
    assert m.completed_bytes == m.offered_bytes
    assert len(m.latencies) == loads["offered", "port"].num_requests


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
def test_score_backends_agree(loads, backend):
    kw = dict(scheme="ssdup+", num_nodes=16, policy="range-offset", ssd_capacity=32 * MiB,
              epoch_seconds=0.5, heartbeat_timeout=2.0)
    want = RS.BurstBufferService(injector=RS.FaultInjector.crash_at(1.0, 3), **kw)
    got = PS.BurstBufferService(injector=PS.FaultInjector.crash_at(1.0, 3),
                                score_backend=backend, device="cpu", **kw)
    assert_same_result(got.run(loads["offered", "port"]), want.run(loads["offered", "ref"]))


def test_run_service_schemes_crash_on_16_nodes(loads):
    kw = dict(num_nodes=16, policy="range-offset", ssd_capacity=32 * MiB, epoch_seconds=0.5,
              heartbeat_timeout=2.0)
    want = RS.run_service_schemes(loads["offered", "ref"],
                                  injector=RS.FaultInjector.crash_at(1.0, 3), **kw)
    got = PS.run_service_schemes(loads["offered", "port"],
                                 injector=PS.FaultInjector.crash_at(1.0, 3), device="cpu", **kw)
    assert got.keys() == want.keys()
    for s in want:
        assert_same_result(got[s], want[s])
        crash = got[s].metrics.faults[0]
        assert crash.kind == "crash" and crash.detected_at is not None
        assert crash.recovery_seconds is not None


# ---------------------------------------------------------------------------
# every fault kind, with and without backlog replay
# ---------------------------------------------------------------------------

FAULTS = {
    # (load, service kwargs, script)
    "crash": ("offered", dict(scheme="orangefs-bb", num_nodes=2, policy="range-offset",
                              ssd_capacity=SMALL, epoch_seconds=0.5, heartbeat_timeout=2.0),
              [(0.3, "crash", 1)]),
    "crash-ssdup+": ("offered", dict(scheme="ssdup+", num_nodes=4, ssd_capacity=64 * MiB,
                                     heartbeat_timeout=2.0), [(1.0, "crash", 0)]),
    "slow": ("sustained", dict(scheme="ssdup+", num_nodes=8, ssd_capacity=64 * MiB,
                               straggler_factor=1.5), [(2.0, "slow", 2, 8.0)]),
    "ssd_degrade-one-node": ("sustained", dict(scheme="ssdup+", num_nodes=1,
                                               ssd_capacity=64 * MiB),
                             [(0.5, "ssd_degrade", 0, 0.1)]),
    "ssd_degrade": ("sustained", dict(scheme="ssdup+", num_nodes=8, ssd_capacity=64 * MiB,
                                      straggler_factor=1.5), [(2.0, "ssd_degrade", 2, 0.05)]),
    "ssd_degrade-ftl": ("sustained", dict(scheme="ssdup+", num_nodes=8, ssd_capacity=64 * MiB,
                                          straggler_factor=1.5, ssd="ftl"),
                        [(2.0, "ssd_degrade", 2, 0.5)]),
    "stall-short": ("offered", dict(scheme="ssdup+", num_nodes=4, ssd_capacity=64 * MiB,
                                    heartbeat_timeout=5.0), [(1.0, "stall", 2, 1.0, 2.0)]),
    "stall-long": ("sustained", dict(scheme="ssdup+", num_nodes=4, ssd_capacity=64 * MiB,
                                     epoch_seconds=0.5, heartbeat_timeout=2.0),
                   [(0.5, "stall", 1, 1.0, 10.0)]),
    "every-kind-ftl": ("sustained", dict(scheme="ssdup+", num_nodes=8, policy="range-offset",
                                         ssd_capacity=32 * MiB, ssd="ftl", epoch_seconds=0.5,
                                         heartbeat_timeout=2.0, admission_occupancy=0.9),
                       [(1.0, "crash", 5), (2.0, "slow", 2, 3.0),
                        (2.0, "ssd_degrade", 6, 0.5), (1.5, "stall", 1, 1.0, 6.0)]),
}


@pytest.mark.parametrize("replay", [True, False])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_scenario_equals_reference(loads, fault, replay):
    load, kw, events = FAULTS[fault]
    got = run_both(loads, load, events, replay=replay, **kw)
    m = got.metrics
    assert m.conservation_violations() == []
    assert len(m.faults) == len(events)
    if fault == "crash":
        assert (m.replayed_bytes > 0) == replay and (m.stranded_bytes > 0) != replay
    if fault in ("slow", "ssd_degrade"):
        assert m.rebalanced_bytes > 0  # the steal_shard rebalance fired
    if fault == "stall-long":
        f = m.faults[0]
        assert f.detected_at is not None and f.recovered_at is not None  # rejoined
    if fault == "stall-short":
        assert m.faults[0].detected_at is None


@pytest.mark.parametrize("action", ["redirect", "reject"])
def test_admission_control_equals_reference(loads, action):
    got = run_both(loads, "offered", scheme="orangefs-bb", num_nodes=2, ssd_capacity=16 * MiB,
                   admission_occupancy=0.5, admission_action=action)
    m = got.metrics
    assert m.conservation_violations() == []
    assert (m.redirected_bytes if action == "redirect" else m.rejected_bytes) > 0


@pytest.mark.parametrize("replay", [True, False])
def test_total_outage_equals_reference(loads, replay):
    got = run_both(loads, "offered", [(0.5, "crash", 0), (0.5, "crash", 1)],
                   scheme="orangefs-bb", num_nodes=2, ssd_capacity=SMALL, epoch_seconds=0.5,
                   heartbeat_timeout=2.0, replay=replay)
    m = got.metrics
    assert m.unserved_bytes > 0 and m.conservation_violations() == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_fault_sweep_equals_reference(loads, seed):
    kw = dict(seed=seed, num_nodes=8, horizon_seconds=3.0, crashes=1, slows=1, degrades=1,
              stalls=1, stall_seconds=4.0)
    inj_ref, inj_port = RS.FaultInjector.random(**kw), PS.FaultInjector.random(**kw)
    assert [dataclasses.asdict(e) for e in inj_port] == [dataclasses.asdict(e) for e in inj_ref]
    run_both(loads, "offered", [dataclasses.astuple(e) for e in inj_ref], scheme="ssdup+",
             num_nodes=8, policy="range-offset", ssd_capacity=32 * MiB, epoch_seconds=0.5,
             heartbeat_timeout=2.0)


def test_validation_matches_reference():
    for kw in (dict(admission_occupancy=1.5), dict(admission_action="tarpit"),
               dict(num_nodes=0), dict(policy="by-vibes"), dict(epoch_seconds=0.0),
               dict(score_backend="abacus")):
        with pytest.raises(ValueError):
            PS.BurstBufferService(device="cpu", **kw)
        if "score_backend" not in kw:
            with pytest.raises(ValueError):
                RS.BurstBufferService(**kw)


# ---------------------------------------------------------------------------
# scoring: one call a run, one more a failover; the oracle's scores exactly
# ---------------------------------------------------------------------------


@pytest.fixture
def scoring_calls(monkeypatch):
    calls = []
    real = port_loop._score_shards_kernel

    def counted(batches, stream_len, device):
        calls.append([b.num_requests for b in batches])
        return real(batches, stream_len, device)

    monkeypatch.setattr(port_loop, "_score_shards_kernel", counted)
    return calls


@pytest.mark.parametrize("scenario", ["healthy", "crash", "two-crashes", "outage"])
def test_one_scoring_call_per_run_plus_one_per_failover(loads, scoring_calls, scenario):
    events = {"healthy": [], "crash": [(1.0, "crash", 3)],
              "two-crashes": [(1.0, "crash", 3), (2.0, "crash", 9)],
              "outage": [(0.5, "crash", n) for n in range(16)]}[scenario]
    svc = ReshardCountingService(num_nodes=16, policy="range-offset", ssd_capacity=32 * MiB,
                           epoch_seconds=0.5, heartbeat_timeout=2.0,
                           injector=_injector(PS, events), device="cpu")
    batch = loads["offered", "port"]
    res = svc.run(batch)
    assert len(scoring_calls) == 1 + svc.reshards
    assert sum(scoring_calls[0]) == batch.num_requests and len(scoring_calls[0]) == 16
    if scenario in ("crash", "two-crashes"):
        assert svc.reshards == len(events)
        # one batch per survivor; node 9 crashed before node 3 was declared
        # dead, so neither failover counts it as a survivor
        assert [len(c) for c in scoring_calls[1:]] == {"crash": [15],
                                                       "two-crashes": [14, 14]}[scenario]
    if scenario == "outage":
        assert svc.reshards == 0
    scoring_calls.clear()
    oracle = PS.BurstBufferService(num_nodes=16, policy="range-offset", ssd_capacity=32 * MiB,
                                   epoch_seconds=0.5, heartbeat_timeout=2.0,
                                   injector=_injector(PS, events), score_backend="numpy",
                                   device="cpu").run(batch)
    assert scoring_calls == []
    assert same_service_result(res, oracle)


def _oracle_windows(batch, stream_len):
    bounds = batch.stream_bounds(stream_len)
    return [stream_stats_batch_np(batch.offsets[None, a:b], batch.sizes[None, a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


EDGE_WINDOWS = {
    # offsets, sizes, stream_len
    "one-request-trace": ([4096], [512], 8),
    "trailing-one-request": (list(range(0, 9 * 4096, 4096))[::-1], [4096] * 9, 8),
    "shorter-than-stream_len": ([7, 3, 99, 1000], [1, 2, 3, 4], 128),
    "ragged-random": (list(np.random.default_rng(5).integers(0, 1 << 40, 37)), [65536] * 37, 16),
    "past-int64-max": ([0, 1 << 40, (1 << 63) - 10, 5], [4096, 4096, 100, 8], 8),
    "past-int64-max-trailing": ([(1 << 63) - 1, 0, 3, 9, 2, 1, 7, 4, (1 << 63) - 5],
                                [1, 1, 1, 1, 1, 1, 1, 1, 64], 8),
}


@pytest.mark.parametrize("case", sorted(EDGE_WINDOWS))
def test_edge_window_scores_equal_the_oracle(case):
    offs, szs, stream_len = EDGE_WINDOWS[case]
    batch = P.TraceBatch.from_numpy(offsets=np.array(offs, dtype=np.int64),
                                    sizes=np.array(szs, dtype=np.int64),
                                    file_ids=np.zeros(len(offs)), app_ids=np.zeros(len(offs)))
    svc = PS.BurstBufferService(stream_len=stream_len, device="cpu")
    (got,) = svc._score([batch])
    want = _oracle_windows(batch, stream_len)
    assert len(got) == len(want)
    for (rf, pct, dist), (orf, opct, odist) in zip(got, want):
        assert (int(rf), int(dist)) == (int(orf[0]), int(odist[0]))
        assert np.float64(pct).tobytes() == np.float64(opct[0]).tobytes()  # bit for bit


@pytest.mark.parametrize("replay", [True, False])
def test_short_failover_windows_equal_reference(loads, replay):
    """``stream_len`` 24 on 3 nodes: a crash leaves a few pending requests
    to reshard, cut into windows shorter than ``stream_len`` and windows of
    one request, all scored in the failover's one call."""

    got = run_both(loads, "offered", [(0.4, "crash", 1)], scheme="ssdup+", num_nodes=3,
                   policy="hash-file", stream_len=24, ssd_capacity=16 * MiB, epoch_seconds=0.25,
                   heartbeat_timeout=0.5, replay=replay)
    assert got.metrics.faults[0].detected_at is not None


def test_trace_ending_past_int64_max_equals_reference():
    """A shard whose trailing one-request window ends past INT64_MAX: the
    scoring call takes the true lengths there, and the results are the
    reference's."""

    rng = np.random.default_rng(3)
    n = 61  # app 0 (node 0): 41 requests, its last a window of its own
    app_ids = np.append(rng.permutation([0] * 40 + [1] * 20), 0).astype(np.int64)
    offs = rng.integers(0, 1 << 30, n).astype(np.int64)
    offs[-1] = np.iinfo(np.int64).max - 100
    cols = dict(offsets=offs, sizes=np.full(n, 4096, dtype=np.int64),
                file_ids=rng.integers(0, 3, n).astype(np.int64), app_ids=app_ids,
                times=np.cumsum(rng.exponential(0.01, n)),
                gap_positions=np.zeros(0, dtype=np.int64), gap_seconds=np.zeros(0))
    kw = dict(scheme="orangefs", num_nodes=2, stream_len=8)
    port = PS.BurstBufferService(device="cpu", **kw)
    batch = P.TraceBatch(**cols)
    shard = batch.select(np.nonzero(app_ids == 0)[0])
    assert shard.num_requests % 8 == 1 and not shard._fill_padded_streams(
        8, *np.empty((2, 6, 8), dtype=np.int64))[1]  # no score-neutral pad exists
    want = RS.BurstBufferService(**kw).run(R.TraceBatch(**cols))
    assert_same_result(port.run(batch), want)


# ---------------------------------------------------------------------------
# the session API, arrivals and the injector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fed_sessions_match_offline_run_and_reference(loads, scheme):
    """Feeding the offline engine's window/gap interleaving reproduces
    ``run()`` bit for bit, with the windows' scores passed in or left to
    the oracle, and equals the reference's session."""

    batch = loads["offered", "port"]
    off = P.IONodeSimulator(scheme=scheme, ssd_capacity=64 * MiB, device="cpu").run(batch)
    svc = PS.BurstBufferService(scheme=scheme, num_nodes=1, ssd_capacity=64 * MiB, device="cpu")
    (scores,) = svc._score([batch])
    for given in (True, False):
        sim = P.IONodeSimulator(scheme=scheme, ssd_capacity=64 * MiB, device="cpu")
        sim.begin_session()
        for kind, payload in svc._build_queue(batch, scores if given else [None] * len(scores)):
            if kind == "gap":
                sim.feed_gap(payload)
            else:
                sim.feed_window(payload.offsets, payload.sizes, payload.file_ids,
                                payload.app_ids, scores=payload.scores)
        assert sim.end_session() == off, given
    want = R.IONodeSimulator(scheme=scheme, ssd_capacity=64 * MiB).run(loads["offered", "ref"])
    assert dataclasses.asdict(off) == dataclasses.asdict(want)


def test_session_errors_match_reference():
    for sim in (P.IONodeSimulator(engine="per-request", device="cpu"),
                R.IONodeSimulator(engine="per-request")):
        with pytest.raises(ValueError):
            sim.begin_session()
    sim = P.IONodeSimulator(stream_len=4, device="cpu")
    sim.begin_session()
    with pytest.raises(RuntimeError):
        sim.begin_session()
    z = np.zeros(0, dtype=np.int64)
    assert sim.feed_window(z, z, z, z) == 0.0
    with pytest.raises(ValueError):
        sim.feed_window(np.arange(5) * 4096, np.full(5, 4096), np.zeros(5), np.zeros(5))
    assert sim.end_session().total_bytes == 0
    with pytest.raises(RuntimeError):
        sim.feed_gap(1.0)


ARRIVALS = {
    "poisson": lambda core, svc: svc.poisson_arrivals(
        core.TraceBatch.from_items(core.mixed(*_apps(core), burst_requests=256).trace),
        rate_rps=500.0, seed=3, start=1.5),
    "poisson-workload": lambda core, svc: svc.poisson_arrivals(
        core.ior("strided", 8, total_bytes=8 * MiB, seed=4), rate_rps=50.0),
    "zipf": lambda core, svc: svc.zipf_mix(_apps(core, total=8 * MiB), rate_rps=1000.0,
                                           s=1.2, seed=4),
    "zipf-flat": lambda core, svc: svc.zipf_mix(_apps(core, total=4 * MiB), rate_rps=10.0,
                                                s=0.0, seed=1),
    "checkpoint": lambda core, svc: svc.checkpoint_arrivals(
        8, waves=3, compute_seconds=20.0, seed=1, bytes_per_wave=16 * MiB),
    "checkpoint-rotating": lambda core, svc: svc.checkpoint_arrivals(
        4, waves=5, compute_seconds=2.5, rotate_files=3, file_id=10, app_id=2,
        bytes_per_wave=4 * MiB, request_size=64 * 1024, seed=6),
}


@pytest.mark.parametrize("case", sorted(ARRIVALS))
def test_arrivals_equal_reference(case):
    a, b = ARRIVALS[case](P, PS), ARRIVALS[case](R, RS)
    for col in ("offsets", "sizes", "file_ids", "app_ids", "times", "gap_positions",
                "gap_seconds"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col


def test_arrivals_reject_what_the_reference_rejects():
    batch = P.TraceBatch.from_numpy(offsets=[0], sizes=[1], file_ids=[0], app_ids=[0])
    with pytest.raises(ValueError):
        PS.poisson_arrivals(batch, rate_rps=0.0)
    with pytest.raises(ValueError):
        PS.zipf_mix([], rate_rps=100.0)
    with pytest.raises(ValueError):
        PS.zipf_mix(_apps(P, total=4 * MiB), rate_rps=1.0, s=-1.0)


@pytest.mark.parametrize("kw", [
    dict(crashes=2, slows=2, stalls=1),
    dict(crashes=1, slows=1, degrades=1, stalls=1, slow_factor=5.0, degrade_factor=0.5,
         stall_seconds=3.0),
    dict(crashes=0, degrades=3),
], ids=["crash-slow-stall", "every-kind", "degrades"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_injector_equals_reference(seed, kw):
    a = PS.FaultInjector.random(seed, num_nodes=8, horizon_seconds=10.0, **kw)
    b = RS.FaultInjector.random(seed, num_nodes=8, horizon_seconds=10.0, **kw)
    assert [dataclasses.asdict(e) for e in a] == [dataclasses.asdict(e) for e in b]
    assert a.events == PS.FaultInjector.random(seed, num_nodes=8, horizon_seconds=10.0,
                                               **kw).events


def test_injector_validation_and_order():
    for bad in (dict(at=1.0, kind="meteor", node=0), dict(at=-1.0, kind="crash", node=0),
                dict(at=1.0, kind="slow", node=0, factor=0.5),
                dict(at=1.0, kind="ssd_degrade", node=0, factor=2.0),
                dict(at=1.0, kind="stall", node=0, duration=0.0)):
        with pytest.raises(ValueError):
            PS.FaultEvent(**bad)
    inj = PS.scripted((5.0, "crash", 1), (1.0, "slow", 0, 3.0),
                      PS.FaultEvent(at=3.0, kind="stall", node=2, duration=1.0))
    assert [e.at for e in inj] == [1.0, 3.0, 5.0] and len(inj) == 3
    assert PS.FAULT_KINDS == RS.FAULT_KINDS
    with pytest.raises(ValueError):
        PS.FaultInjector.random(0, num_nodes=2, horizon_seconds=1.0, crashes=3)


def test_public_names_match_reference():
    assert sorted(PS.__all__) == sorted(RS.__all__)
    for name in RS.__all__:
        assert hasattr(PS, name), name


def test_fault_free_straggler_rebalance_equals_reference():
    """With no fault injected, the straggler rule can still fire on the
    lanes' own imbalance and move windows (``orangefs-bb``, 100,000
    requests on 8 nodes); the run then differs from ``FleetSimulator``,
    in the reference as in the port, and equals it with the rule off."""

    from repro_torch.testing.traces import sweep_trace

    port_batch = PS.poisson_arrivals(sweep_trace(100_000), rate_rps=50_000.0, seed=7)
    ref_batch = R.TraceBatch(**{c: getattr(port_batch, c) for c in (
        "offsets", "sizes", "file_ids", "app_ids", "times", "gap_positions", "gap_seconds")})
    kw = dict(scheme="orangefs-bb", num_nodes=8, policy="range-offset",
              ssd_capacity=port_batch.total_bytes // 16)
    got = PS.BurstBufferService(device="cpu", **kw).run(port_batch)
    assert_same_result(got, RS.BurstBufferService(**kw).run(ref_batch))
    assert got.metrics.rebalanced_bytes > 0 and got.metrics.faults == []
    offline = P.FleetSimulator(device="cpu", **kw).run(port_batch)
    assert got.node_results != offline.node_results
    calm = PS.BurstBufferService(straggler_factor=float("inf"), device="cpu", **kw).run(port_batch)
    assert calm.metrics.rebalanced_bytes == 0 and calm.node_results == offline.node_results
