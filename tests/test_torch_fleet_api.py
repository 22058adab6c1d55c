"""The port's fleet API (``FleetSimulator``, ``run_fleet_schemes``,
``FleetResult``, ``FleetProgram``'s ``score_backend`` and any
``stream_len``) and the golden-fixture writer against the reference.

* ``FleetSimulator``/``run_fleet_schemes``: bit-equal to the reference's
  (tolerance 0) with ``score_backend`` ``"numpy"`` and ``"kernel"`` (the
  kernel's plain version on the CPU), both threshold scopes, both storage
  models.
* The 16 golden fixtures replay exactly through the port's batched engine;
  ``make_fixture`` gives the committed JSON field for field and
  ``generate_all`` writes it byte for byte, into a temporary directory.
* ``FleetResult``: every public member of the reference's exists and gives
  the same value on the same node results.
* Scoring at ``stream_len`` 17, 96 and 2048 equals the reference's NumPy
  scores, and ``FleetProgram`` runs at those lengths.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.core as R
from repro.testing.traces import golden_trace as ref_golden_trace
from repro_torch.core import (FleetProgram, FleetResult, FleetSimulator, SimResult, TraceBatch,
                              compute_stream_scores, run_fleet_schemes)
from repro_torch.core.trace import _score_shards_kernel
from repro_torch.kernels.stream_rf import ops
from repro_torch.testing import golden
from repro_torch.testing.traces import golden_trace

SCHEMES = golden.FIXTURE_SCHEMES
FIXTURES = [(s, w, p) for s in SCHEMES for w in golden.FIXTURE_WORKLOADS
            for p in golden.FIXTURE_POLICIES]
PUBLIC = sorted(m for m in dir(R.FleetResult) if not m.startswith("_"))


def _props(fr) -> dict:
    out = {}
    for m in PUBLIC:
        v = getattr(fr, m)
        if m == "node_results":
            v = tuple(dataclasses.asdict(r) for r in v)
        out[m] = v
    return out


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("scope", ["node", "fleet"])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("policy", golden.FIXTURE_POLICIES)
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_run_fleet_schemes_equals_reference(workload, policy, backend, scope, ssd):
    batch = golden_trace(workload)
    kw = dict(num_nodes=4, policy=policy, threshold_scope=scope,
              ssd_capacity=golden._node_capacity(batch.total_bytes))
    if ssd == "ftl":
        kw["ssd"] = "ftl"
    got = run_fleet_schemes(batch, score_backend=backend, device="cpu", **kw)
    want = R.run_fleet_schemes(ref_golden_trace(workload), **kw)
    assert got.keys() == want.keys()
    for s in want:
        assert _props(got[s]) == _props(want[s]), s


@pytest.mark.parametrize("engine", ["per-request", "batched"])
def test_fleet_simulator_engines_equal_reference(engine):
    batch = golden_trace("mixed-burst")
    kw = dict(num_nodes=3, scheme="ssdup+", policy="hash-file", engine=engine,
              ssd_capacity=24 << 20, index_backend="avl")
    got = FleetSimulator(device="cpu", **kw)
    want = R.FleetSimulator(**kw)
    assert np.array_equal(got.assignment(batch), want.assignment(ref_golden_trace("mixed-burst")))
    assert _props(got.run(batch)) == _props(want.run(ref_golden_trace("mixed-burst")))


def test_fleet_simulator_scores_every_shard_in_one_launch(monkeypatch):
    """One scoring call for all shards, and for the whole trace too when
    the threshold scope is the fleet's."""

    calls = []
    real = ops.stream_stats_op

    def counted(o, s, lengths=None):
        calls.append(o.shape)
        return real(o, s, lengths)

    monkeypatch.setattr(ops, "stream_stats_op", counted)
    batch = golden_trace("mixed-burst")
    FleetSimulator(num_nodes=4, device="cpu").run(batch)
    FleetSimulator(num_nodes=4, threshold_scope="fleet", device="cpu").run(batch)
    rows = -(-batch.num_requests // 128)
    assert len(calls) == 2 and calls[1][0] >= calls[0][0] + rows


@pytest.mark.parametrize("scheme,workload,policy", FIXTURES, ids=["__".join(f) for f in FIXTURES])
def test_golden_fixtures_replay_exactly(scheme, workload, policy):
    payload = golden.load_fixture(golden.fixture_path(scheme, workload, policy))
    result = golden.replay_fixture(payload, device="cpu")
    assert golden.check_fixture(payload, result) == []
    made = golden.make_fixture(scheme, workload, policy, device="cpu")
    assert made == json.loads(json.dumps(payload))  # field for field


def test_fixture_replay_under_other_engine_and_index():
    payload = golden.load_fixture(golden.fixture_path("ssdup+", "strided-gaps", "range-offset"))
    for engine, index in (("per-request", "numpy"), ("batched", "avl")):
        result = golden.replay_fixture(payload, engine=engine, index_backend=index, device="cpu")
        assert golden.check_fixture(payload, result) == []
    with pytest.raises(golden.GoldenStorageMismatch):
        golden.replay_fixture(payload, ssd="ftl", device="cpu")
    drifted = dict(payload, trace=dict(payload["trace"], num_requests=1))
    with pytest.raises(golden.GoldenTraceMismatch):
        golden.replay_fixture(drifted, device="cpu")


def test_generate_all_writes_the_committed_files(tmp_path):
    written = golden.generate_all(tmp_path, schemes=("orangefs", "ssdup+"),
                                  workloads=("strided-gaps",), device="cpu")
    assert len(written) == 4
    for path in written:
        assert path.parent == tmp_path
        assert path.read_bytes() == (golden.GOLDEN_DIR / path.name).read_bytes()
    assert golden.main(["--write", str(tmp_path / "again"), "--device", "cpu"]) == 0
    assert len(list((tmp_path / "again").glob("*.json"))) == 16


def test_first_divergence_names_the_causally_earliest_field():
    payload = golden.load_fixture(golden.fixture_path("ssdup", "mixed-burst", "range-offset"))
    actual = json.loads(json.dumps(payload["result"]))
    assert golden.first_divergence(payload["result"], actual) is None
    actual["nodes"][3]["io_seconds"] += 1.0
    actual["nodes"][2]["bytes_to_ssd"] += 4096
    assert golden.first_divergence(payload["result"], actual).startswith("node[2].bytes_to_ssd")
    assert golden.device_tolerance_metadata() == payload["device_tolerance"]
    assert golden.storage_model_metadata(None, payload["key"]["ssd_capacity"]) == \
        payload["storage_model"]


def _parity_nodes(seed: int):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(5):
        b_ssd, b_hdd = (int(x) for x in rng.integers(0, 1 << 30, size=2))
        io = float(rng.random()) * (i != 2)  # one node with no I/O time
        nodes.append(dict(scheme="ssdup+", io_seconds=io, total_seconds=io + 1.0,
                          total_bytes=b_ssd + b_hdd, bytes_to_ssd=b_ssd,
                          bytes_to_hdd_direct=b_hdd, flushes=i, flush_paused_seconds=0.5,
                          blocked_seconds=0.25, peak_ssd_occupancy=b_ssd, metadata_bytes=24,
                          per_app_bytes={0: b_ssd, 1: b_hdd}))
    return nodes


@pytest.mark.parametrize("seed", range(3))
def test_fleet_result_members_equal_reference(seed):
    nodes = _parity_nodes(seed)
    for k in (0, 1, 5):  # an empty fleet too
        got = FleetResult("ssdup+", "range-offset", k, tuple(SimResult(**n) for n in nodes[:k]))
        want = R.FleetResult("ssdup+", "range-offset", k,
                             tuple(R.SimResult(**n) for n in nodes[:k]))
        assert _props(got) == _props(want)
    assert {"ssd_byte_ratio", "straggler", "node_throughputs_mbs", "node_bytes"} <= set(PUBLIC)


@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_fleet_program_results_have_the_reference_members(workload):
    """On the device engine's parity case: every member of the port's
    FleetProgram results equals the reference's definition on the same node
    results."""

    batch = golden_trace(workload)
    res = FleetProgram(num_nodes=4, policy="range-offset", device="cpu",
                       ssd_capacity=golden._node_capacity(batch.total_bytes)).run(batch)
    for fr in res.values():
        twin = R.FleetResult(fr.scheme, fr.policy, fr.num_nodes,
                             tuple(R.SimResult(**dataclasses.asdict(r)) for r in fr.node_results))
        assert _props(fr) == _props(twin)


@pytest.mark.parametrize("stream_len", [17, 96, 2048])
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_any_stream_len_scores_equal_reference_numpy(workload, stream_len):
    batch, ref_batch = golden_trace(workload), ref_golden_trace(workload)
    want = R.compute_stream_scores(ref_batch, stream_len, backend="numpy")
    shards = FleetProgram(num_nodes=3, device="cpu").shard(batch)
    ref_shards = R.FleetSimulator(num_nodes=3).shard(ref_batch)
    got_all = [compute_stream_scores(batch, stream_len, device="cpu")]
    got_all += _score_shards_kernel(shards, stream_len, "cpu")
    want_all = [want] + [R.compute_stream_scores(s, stream_len, backend="numpy")
                         for s in ref_shards]
    for got, w in zip(got_all, want_all):
        for f in ("rf_sum", "percentage", "seek_distance", "nbytes", "offset_sum"):
            assert np.array_equal(getattr(got, f), getattr(w, f)), f
        assert len(got) == len(w)
        got.validate()


@pytest.mark.parametrize("stream_len", [96, 2048])
def test_fleet_program_runs_at_any_stream_len(stream_len):
    """The fault this pins: FleetProgram refused every stream length that
    was not a power of two in [2, 1024].  Both score backends now give the
    same sweep, within the device tolerances of the reference's batched
    engine at the same length."""

    batch = golden_trace("strided-gaps")
    res = FleetProgram(num_nodes=2, stream_len=stream_len, device="cpu").run(batch)
    same = FleetProgram(num_nodes=2, stream_len=stream_len, score_backend="numpy",
                        device="cpu").run(batch)
    for s in res:
        assert golden.fleet_result_to_dict(res[s]) == golden.fleet_result_to_dict(same[s])
        assert res[s].total_bytes == batch.total_bytes
    ref = R.run_fleet_schemes(ref_golden_trace("strided-gaps"), num_nodes=2,
                              stream_len=stream_len, ssd_capacity=8 << 30)
    tol = {k: list(v) for k, v in golden.device_tolerance_metadata().items()}
    for s in ref:
        assert golden.diff_fleet(golden.fleet_result_to_dict(ref[s]),
                                 golden.fleet_result_to_dict(res[s]), tolerances=tol) == []


def test_above_the_kernel_limit_numpy_scores_it():
    batch = golden_trace("mixed-burst")
    with pytest.raises(ValueError, match="numpy"):
        compute_stream_scores(batch, ops.MAX_STREAM_LEN + 1, device="cpu")
    got = compute_stream_scores(batch, ops.MAX_STREAM_LEN + 1, backend="numpy")
    want = R.compute_stream_scores(ref_golden_trace("mixed-burst"), ops.MAX_STREAM_LEN + 1)
    assert np.array_equal(got.rf_sum, want.rf_sum)


def test_fleet_classes_refuse_unknown_arguments():
    for cls in (FleetSimulator, FleetProgram):
        with pytest.raises(ValueError, match="score_backend"):
            cls(score_backend="jnp", device="cpu")
        with pytest.raises(ValueError, match="policy"):
            cls(policy="nope", device="cpu")
        with pytest.raises(ValueError):
            cls(num_nodes=0, device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        FleetSimulator(threshold_scope="fleet", threshold_warmup=[0.5], device="cpu")


def test_tail_stream_ending_past_int64_max_scores_exactly(monkeypatch):
    """A fault this pins: a trailing partial stream whose sorted-last
    request ends past INT64_MAX made the host pad overflow (OverflowError).
    Such a launch now passes every row's true length, so the pad is
    inert; every other launch keeps its score-neutral pads."""

    big = np.iinfo(np.int64).max
    offs = np.array([5, big - 10, 4096, big - 10, 77], dtype=np.int64)
    batch = TraceBatch.from_numpy(offsets=offs, sizes=np.full(5, 4096), file_ids=np.zeros(5),
                                  app_ids=np.zeros(5))
    ref_batch = R.TraceBatch.from_items([R.Request(int(o), 4096) for o in offs])
    seen = []
    real = ops.stream_stats_op

    def counted(o, s, lengths=None):
        seen.append(lengths is not None)
        return real(o, s, lengths)

    monkeypatch.setattr(ops, "stream_stats_op", counted)
    for stream_len in (2, 3, 4, 8):
        got = compute_stream_scores(batch, stream_len, device="cpu")
        want = R.compute_stream_scores(ref_batch, stream_len, backend="numpy")
        for f in ("rf_sum", "percentage", "seek_distance", "nbytes"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), (stream_len, f)
    # the trailing stream ends past INT64_MAX at stream_len 3 and 8 only
    assert seen == [False, True, False, True]
