"""The port's page-mapped FTL (``repro_torch.core.ftl``), its storage-model
plumbing (``device_model``) and the FTL lanes of ``FleetProgram`` against
the reference.

* ``FTLModel``: the same seeded ``charge_write``/``trim`` sequences give
  bit-equal service times, equal ``stats()`` and equal mapping state, one
  request at a time or in batches (tolerance 0).
* Lanes: the FTL columns of ``lane_consts``/``initial_lane_state`` and the
  event tapes built with an FTL model equal the reference's arrays.
* ``FleetProgram(ssd="ftl", device="cpu")`` within ``DEVICE_TOLERANCES`` of
  the reference's batched engine with ``ssd="ftl"`` at the fixtures'
  capacity, where GC fires on strided-gaps.  The live JAX engine's FTL
  cases are in ``tests/test_torch_engine_device.py``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core import engine_device as ref_ed
from repro.core.device_model import IngestLink as RefLink
from repro.core.device_model import make_storage_model as ref_make
from repro.testing.traces import golden_trace as ref_golden_trace
from repro_torch.analysis import sanitize
from repro_torch.core import FleetProgram, FTLModel, SSDModel, StorageModel
from repro_torch.core import device_model as dm
from repro_torch.core import engine_device as ed
from repro_torch.core.trace import compute_stream_scores
from repro_torch.testing import golden
from repro_torch.testing.traces import golden_trace


def _ops(seed: int, logical: int, n: int = 400):
    """A seeded sequence of ("w", offsets, sizes) and ("t", offset, nbytes)
    operations: random in-place writes, log appends and region trims."""

    rng = np.random.default_rng(seed)
    ops, tail = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.45:  # random writes, some duplicated within the batch
            k = int(rng.integers(1, 40))
            szs = rng.integers(0, 9, size=k) * 4096 + rng.integers(0, 2, size=k) * 100
            offs = rng.integers(0, (logical - 40_000) // 512, size=k) * 512
            ops.append(("w", offs.astype(np.int64), szs.astype(np.int64)))
        elif r < 0.85:  # a log append run
            k = int(rng.integers(1, 60))
            szs = np.full(k, 16384, dtype=np.int64)
            if tail + int(szs.sum()) > logical:
                tail = 0
            offs = tail + np.concatenate([[0], np.cumsum(szs)[:-1]]).astype(np.int64)
            tail += int(szs.sum())
            ops.append(("w", offs, szs))
        else:
            lo = int(rng.integers(0, logical // 2))
            ops.append(("t", lo, int(rng.integers(0, logical // 2))))
    return ops


def _replay(model, ops, one_by_one: bool):
    times = []
    for op in ops:
        if op[0] == "t":
            model.trim(op[1], op[2])
            continue
        _, offs, szs = op
        if one_by_one:
            times.extend(float(model.charge_write(offs[i:i + 1], szs[i:i + 1], t=1.5)[0])
                         for i in range(len(szs)))
        else:
            times.extend(model.charge_write(offs, szs, t=1.5).tolist())
    return np.asarray(times)


def _state(m):
    return (m._l2p.tolist(), m._p2l.tolist(), m._valid.tolist(), m._sealed.tolist(),
            list(m._free), m._open, m._fp, m.free_pages, m.live_pages, m.free_blocks,
            m.host_bytes, m.host_pages, m.reloc_pages, m.trimmed_pages, m.erases,
            m.gc_runs, m.last_t)


GEOMETRIES = [
    dict(),
    dict(pages_per_block=32, n_channels=4, overprovision=0.1, gc_low_blocks=2,
         gc_high_blocks=5),
    dict(page_size=8192, pages_per_block=16, t_erase=3e-3, read_bw=300e6),
]


@pytest.mark.parametrize("one_by_one", [False, True], ids=["batched", "per-request"])
@pytest.mark.parametrize("geom", range(len(GEOMETRIES)))
@pytest.mark.parametrize("seed", range(3))
def test_ftl_model_equals_reference(seed, geom, one_by_one):
    logical = 2 << 20
    kw = GEOMETRIES[geom]
    ops = _ops(seed, logical)
    port = FTLModel(logical_bytes=logical, **kw)
    ref = R.FTLModel(logical_bytes=logical, **kw)
    got, want = _replay(port, ops, one_by_one), _replay(ref, ops, one_by_one)
    assert np.array_equal(got, want)  # bit-equal service times
    assert port.stats() == ref.stats()
    assert _state(port) == _state(ref)
    assert (port.wa, port.t_page, port.write_bw, port.total_pages, port.num_blocks) == \
        (ref.wa, ref.t_page, ref.write_bw, ref.total_pages, ref.num_blocks)
    assert port.stats()["reloc_pages"] > 0 or seed  # GC fires in every geometry at seed 0
    with sanitize.sanitizing():
        port.sanitize_check()


@pytest.mark.parametrize("seed", range(2))
def test_ftl_batching_does_not_change_times(seed):
    """The engine-parity contract: one call per request and one call per
    batch give the same times and the same state."""

    ops = _ops(seed, 1 << 20)
    a, b = FTLModel(logical_bytes=1 << 20), FTLModel(logical_bytes=1 << 20)
    assert np.array_equal(_replay(a, ops, True), _replay(b, ops, False))
    assert _state(a) == _state(b)


def test_clone_degraded_fingerprint_equal_reference():
    port, ref = FTLModel(logical_bytes=3 << 20), R.FTLModel(logical_bytes=3 << 20)
    ops = _ops(0, 3 << 20, 50)
    _replay(port, ops, False)
    _replay(ref, ops, False)
    pc, rc = port.clone(), ref.clone()
    assert _state(pc) == _state(rc) and pc.host_pages == 0
    assert port.config_fingerprint() == ref.config_fingerprint()
    assert port.degraded(0.5) is port and ref.degraded(0.5) is ref
    assert port.config_fingerprint() == ref.config_fingerprint()
    assert _state(port) == _state(ref)
    assert port.read_time(1 << 20) == ref.read_time(1 << 20)
    assert port.write_time(1 << 20) == ref.write_time(1 << 20)
    ssd, rssd = SSDModel(), R.SSDModel()
    assert ssd.clone() is ssd
    assert dataclasses.asdict(ssd.degraded(0.25)) == dataclasses.asdict(rssd.degraded(0.25))
    assert ssd.config_fingerprint() == rssd.config_fingerprint()
    sizes = np.arange(1, 50) * 4096
    assert np.array_equal(ssd.charge_write(None, sizes), rssd.charge_write(None, sizes))


def test_ftl_refuses_what_the_reference_refuses():
    m = FTLModel(logical_bytes=1 << 20)
    for bad in ((None, [4096]), ([(1 << 20) - 100], [4096]), ([-4096], [4096])):
        with pytest.raises(ValueError):
            m.charge_write(*bad)
    for kw in (dict(logical_bytes=0), dict(logical_bytes=1 << 20, gc_low_blocks=5,
                                            gc_high_blocks=5)):
        with pytest.raises(ValueError):
            FTLModel(**kw)


def test_make_storage_model_and_clone_storage():
    assert dm.STORAGE_BACKENDS == ("constant", "ftl")
    ftl = dm.make_storage_model("ftl", logical_bytes=4 << 20)
    assert isinstance(ftl, FTLModel) and isinstance(ftl, StorageModel)
    assert ftl.config_fingerprint() == ref_make("ftl", logical_bytes=4 << 20).config_fingerprint()
    assert isinstance(dm.make_storage_model(None), SSDModel)
    assert dm.make_storage_model(ftl) is ftl
    with pytest.raises(ValueError, match="capacity"):
        dm.make_storage_model("ftl")
    with pytest.raises(ValueError, match="unknown"):
        dm.make_storage_model("nvme")
    with pytest.raises(TypeError):
        dm.make_storage_model(3.0)
    assert dm.clone_storage("ftl") == "ftl" and dm.clone_storage(None) is None
    copy = dm.clone_storage(ftl)
    assert copy is not ftl and copy.config_fingerprint() == ftl.config_fingerprint()
    assert dm.clone_storage(SSDModel()) == SSDModel()
    assert dm.IngestLink().time(1 << 20) == RefLink().time(1 << 20)
    assert (dm.LOCAL_BURST_TIER, dm.REMOTE_PFS_TIER) == (
        dm.TierSpec("local-nvme", bw=2.0e9), dm.TierSpec("remote-pfs", bw=0.5e9, seek_time=0.8e-3))


@pytest.mark.parametrize("scheme", sorted(ed.SCHEME_IDS))
def test_ftl_lane_columns_equal_reference(scheme):
    cap = 6 << 20
    port = dm.make_storage_model("ftl", logical_bytes=cap)
    ref = ref_make("ftl", logical_bytes=cap)
    got, want = ed.lane_consts(scheme, cap, 0.5, ssd=port), ref_ed.lane_consts(scheme, cap, 0.5, ssd=ref)
    assert got.keys() == want.keys() and all(got[k] == want[k] for k in want)
    assert bool(got["ftl_on"])
    got = ed.initial_lane_state(scheme, 64, None, ssd=port)
    want = ref_ed.initial_lane_state(scheme, 64, None, ssd=ref)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_ftl_event_tape_equals_reference(workload):
    ref_batch, batch = ref_golden_trace(workload), golden_trace(workload)
    cap = golden._node_capacity(batch.total_bytes)
    got = ed.build_events(batch, compute_stream_scores(batch, device="cpu"),
                          ssd=dm.make_storage_model("ftl", logical_bytes=cap))
    want = ref_ed.build_events(ref_batch, R.compute_stream_scores(ref_batch),
                               ssd=ref_make("ftl", logical_bytes=cap))
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def ftl_sweeps():
    """4-node x 4-scheme FTL sweeps at the fixtures' capacity: the port's
    FleetProgram on the CPU and the reference's batched engine."""

    runs = {}
    for wl in golden.FIXTURE_WORKLOADS:
        for policy in golden.FIXTURE_POLICIES:
            batch = golden_trace(wl)
            cap = golden._node_capacity(batch.total_bytes)
            prog = FleetProgram(num_nodes=4, policy=policy, ssd_capacity=cap, ssd="ftl",
                                device="cpu")
            got = prog.run(batch)
            want = R.run_fleet_schemes(ref_golden_trace(wl), num_nodes=4, policy=policy,
                                       ssd_capacity=cap, ssd="ftl", engine="batched")
            runs[wl, policy] = got, want, prog._replay(batch)[0]
    return runs


@pytest.mark.parametrize("policy", golden.FIXTURE_POLICIES)
@pytest.mark.parametrize("workload", golden.FIXTURE_WORKLOADS)
def test_ftl_fleet_program_within_device_tolerances_of_reference(ftl_sweeps, workload, policy):
    got, want, _ = ftl_sweeps[workload, policy]
    tol = {k: list(v) for k, v in ed.DEVICE_TOLERANCES.items()}
    for scheme in want:
        diffs = golden.diff_fleet(golden.fleet_result_to_dict(want[scheme]),
                                  golden.fleet_result_to_dict(got[scheme]), tolerances=tol)
        assert diffs == [], "\n".join(diffs)


def test_ftl_gc_fires_in_the_fixture_sweeps(ftl_sweeps):
    reloc = {k: float(v[2]["ftl_reloc_pages"].sum()) for k, v in ftl_sweeps.items()}
    assert reloc["strided-gaps", "round-robin-app"] > 0, reloc


def test_ftl_lanes_carry_their_own_state():
    """Each lane's FTL columns evolve on their own: a lane replayed alone
    gives the same numbers as inside the 16-lane sweep."""

    batch = golden_trace("strided-gaps")
    cap = golden._node_capacity(batch.total_bytes)
    prog = FleetProgram(num_nodes=4, schemes=("ssdup+",), policy="round-robin-app",
                        ssd_capacity=cap, ssd="ftl", device="cpu")
    swept = prog.run(batch)["ssdup+"]
    for i, shard in enumerate(prog.shard(batch)):
        alone = ed.simulate_device(shard, scheme="ssdup+", ssd_capacity=cap,
                                   ssd=dm.make_storage_model("ftl", logical_bytes=cap),
                                   device="cpu")
        assert golden.sim_result_to_dict(alone) == golden.sim_result_to_dict(swept.node_results[i])
