"""The port's replay engines (``repro_torch.core.simulator``) against the
reference's.

* ``IONodeSimulator`` with ``engine="per-request"`` and ``"batched"``, all
  four schemes, both golden workloads, ``ssd`` constant and FTL at 4 MiB
  (where GC fires): every ``SimResult`` field bit-equal to the reference's
  (tolerance 0), the FTL's own ledgers equal too.
* The incremental session (``begin_session``/``feed_window``/``feed_gap``/
  ``end_session``) equal to the reference's, window by window.
* ``run_schemes`` equal to the reference's; ``engine="device"`` within
  ``DEVICE_TOLERANCES`` of the batched engine at the fixtures' configuration.
* Scoring on the CPU: the kernel backend's plain version and the NumPy
  oracle give the same results.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.testing.traces import golden_trace as ref_golden_trace
from repro_torch.core import FleetProgram, FleetSimulator, IONodeSimulator, SimResult, run_schemes
from repro_torch.core import engine_device as ed
from repro_torch.core.trace import Gap, TraceBatch
from repro_torch.testing import golden
from repro_torch.testing.traces import golden_trace

SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
FTL_CAPACITY = 4 << 20


def _fields(r) -> dict:
    return dataclasses.asdict(r)


def _ssd_kw(ssd: str, workload: str) -> dict:
    if ssd == "ftl":
        return dict(ssd="ftl", ssd_capacity=FTL_CAPACITY)
    return dict(ssd_capacity=golden._node_capacity(golden_trace(workload).total_bytes))


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("engine", ["per-request", "batched"])
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_engines_equal_reference(scheme, workload, engine, ssd):
    kw = dict(scheme=scheme, engine=engine, **_ssd_kw(ssd, workload))
    port = IONodeSimulator(device="cpu", **kw)
    ref = R.IONodeSimulator(**kw)
    got = port.run(golden_trace(workload))
    want = ref.run(ref_golden_trace(workload))
    assert _fields(got) == _fields(want)
    if ssd == "ftl":
        assert port.ssd.stats() == ref.ssd.stats()


def test_ftl_gc_fires_at_4_mib():
    """GC runs in the host engines' FTL at 4 MiB (log appends and trims
    leave whole blocks invalid, so it erases without relocating), and the
    device engine's analytic GC relocates pages there."""

    runs, relocs = [], []
    for workload in golden.FIXTURE_WORKLOADS:
        for scheme in SCHEMES[1:]:
            sim = IONodeSimulator(scheme=scheme, device="cpu", **_ssd_kw("ftl", workload))
            sim.run(golden_trace(workload))
            runs.append(sim.ssd.stats()["gc_runs"])
        prog = FleetProgram(num_nodes=1, schemes=SCHEMES[1:], device="cpu",
                            **_ssd_kw("ftl", workload))
        lanes, _ = prog._replay(golden_trace(workload))
        relocs.append(float(lanes["ftl_reloc_pages"].sum()))
    assert max(runs) > 0 and max(relocs) > 0, (runs, relocs)


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_both_score_backends_replay_alike(workload, backend):
    batch = golden_trace(workload)
    cap = golden._node_capacity(batch.total_bytes)
    got = IONodeSimulator(scheme="ssdup+", ssd_capacity=cap, score_backend=backend,
                          device="cpu").run(batch)
    want = R.IONodeSimulator(scheme="ssdup+", ssd_capacity=cap).run(ref_golden_trace(workload))
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_run_schemes_equals_reference(workload, ssd):
    kw = _ssd_kw(ssd, workload)
    got = run_schemes(golden_trace(workload), device="cpu", **kw)
    want = R.run_schemes(ref_golden_trace(workload), **kw)
    assert got.keys() == want.keys()
    for s in want:
        assert _fields(got[s]) == _fields(want[s]), s
        assert got[s].app_throughput_mbs(0) == want[s].app_throughput_mbs(0)
        assert got[s].app_throughput_mbs(99) == want[s].app_throughput_mbs(99) == 0.0


def test_run_schemes_takes_item_lists_and_shared_scores():
    batch = golden_trace("strided-gaps")
    items = batch.to_items()
    assert any(isinstance(i, Gap) for i in items)
    assert TraceBatch.from_items(items).to_items() == items
    a = run_schemes(items, device="cpu", engine="per-request")
    b = run_schemes(batch, device="cpu")
    assert {s: _fields(r) for s, r in a.items()} == {s: _fields(r) for s, r in b.items()}


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("policy", golden.FIXTURE_POLICIES)
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_device_engine_within_tolerances_of_batched(workload, policy, ssd):
    """``engine="device"`` per node against ``engine="batched"`` at the
    fixtures' configuration (4 nodes, half a node's share of the trace),
    the configuration the device engine's tolerance table is held to."""

    batch = golden_trace(workload)
    kw = dict(num_nodes=golden.FIXTURE_NODES, policy=policy, device="cpu",
              ssd_capacity=golden._node_capacity(batch.total_bytes))
    if ssd == "ftl":
        kw["ssd"] = "ftl"
    tol = {k: list(v) for k, v in ed.DEVICE_TOLERANCES.items()}
    for s in SCHEMES:
        dev = FleetSimulator(scheme=s, engine="device", **kw).run(batch)
        host = FleetSimulator(scheme=s, engine="batched", **kw).run(batch)
        diffs = golden.diff_fleet(golden.fleet_result_to_dict(host),
                                  golden.fleet_result_to_dict(dev), tolerances=tol)
        assert diffs == [], (s, diffs)


def _session(sim, batch, windows_at):
    """Feed ``batch`` as windows of the given sizes, gaps where they fall."""

    sim.begin_session()
    deltas, pos, gi = [], 0, 0
    for n in windows_at:
        while gi < batch.num_gaps and batch.gap_positions[gi] <= pos:
            deltas.append(sim.feed_gap(float(batch.gap_seconds[gi])))
            gi += 1
        sl = slice(pos, min(pos + n, batch.num_requests))
        deltas.append(sim.feed_window(batch.offsets[sl], batch.sizes[sl], batch.file_ids[sl],
                                      batch.app_ids[sl], force_hdd=n == 17))
        pos = sl.stop
    while gi < batch.num_gaps:
        deltas.append(sim.feed_gap(float(batch.gap_seconds[gi])))
        gi += 1
    return deltas, sim.end_session(drain=windows_at[0] != 5)


@pytest.mark.parametrize("ssd", ["constant", "ftl"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_incremental_session_equals_reference(scheme, ssd):
    workload = "strided-gaps"
    kw = dict(scheme=scheme, stream_len=64, **_ssd_kw(ssd, workload))
    batch, ref_batch = golden_trace(workload), ref_golden_trace(workload)
    rng = np.random.default_rng(len(scheme))
    for windows in ([64] * 10, list(rng.integers(1, 65, size=40)) + [17] * 3, [5] * 130):
        got = _session(IONodeSimulator(device="cpu", **kw), batch, windows)
        want = _session(R.IONodeSimulator(**kw), ref_batch, windows)
        assert got[0] == want[0]
        assert _fields(got[1]) == _fields(want[1])


def test_session_misuse_raises_like_the_reference():
    sim = IONodeSimulator(device="cpu", engine="per-request")
    with pytest.raises(ValueError, match="batched"):
        sim.begin_session()
    sim = IONodeSimulator(device="cpu", stream_len=8)
    with pytest.raises(RuntimeError):
        sim.feed_gap(1.0)
    sim.begin_session()
    with pytest.raises(RuntimeError):
        sim.begin_session()
    with pytest.raises(ValueError, match="stream_len"):
        sim.feed_window(np.arange(9), np.ones(9), np.zeros(9), np.zeros(9))


def test_sanitized_run_is_bit_identical():
    batch = golden_trace("mixed-burst")
    kw = dict(scheme="ssdup+", ssd="ftl", ssd_capacity=FTL_CAPACITY, device="cpu")
    plain = IONodeSimulator(**kw).run(batch)
    checked = IONodeSimulator(sanitize=True, **kw).run(batch)
    assert _fields(plain) == _fields(checked)


def test_constructor_refuses_what_the_reference_refuses():
    for kw in (dict(scheme="nope"), dict(engine="jit"), dict(scheme="orangefs",
               threshold_warmup=[0.5]), dict(flush_gate="host"), dict(score_backend="pallas")):
        with pytest.raises(ValueError):
            IONodeSimulator(device="cpu", **kw)


def test_sim_result_members_equal_reference():
    assert [f.name for f in dataclasses.fields(SimResult)] == \
        [f.name for f in dataclasses.fields(R.SimResult)]
    members = {m for m in dir(R.SimResult) if not m.startswith("_")}
    assert members <= {m for m in dir(SimResult) if not m.startswith("_")}
