"""The port's workload generators reproduce the reference's traces to the
byte: the golden fixtures' stored fingerprints, the generators' columns for
a spread of patterns, and the checkpoint waves; ``reshard_to_survivors``
gives the reference's assignment over every policy and dead set."""

import json

import numpy as np
import pytest

from repro.core import workloads as ref_w
from repro_torch.core import workloads as port_w
from repro_torch.testing.golden import GOLDEN_DIR, fixture_name
from repro_torch.testing.traces import GOLDEN_WORKLOADS, golden_trace, trace_fingerprint


@pytest.mark.parametrize("workload", sorted(GOLDEN_WORKLOADS))
def test_golden_trace_matches_fixture_fingerprint(workload):
    with open(GOLDEN_DIR / fixture_name("ssdup+", workload, "range-offset")) as f:
        stored = json.load(f)["trace"]
    assert trace_fingerprint(golden_trace(workload)) == stored


def _cols(w):
    return np.array([(r.offset, r.size, r.file_id, r.app_id, r.time)
                     for r in w.trace], dtype=np.float64).reshape(-1, 5)


CASES = {
    "ior-seg-contig": lambda m: m.ior("segmented-contiguous", 8, total_bytes=8 * m.MiB, seed=1),
    "ior-seg-random": lambda m: m.ior("segmented-random", 16, total_bytes=8 * m.MiB, seed=2),
    "ior-strided": lambda m: m.ior("strided", 32, total_bytes=8 * m.MiB, seed=3),
    "ior-skew0": lambda m: m.ior("strided", 4, total_bytes=2 * m.MiB, skew=0.0),
    "hpio-cc": lambda m: m.hpio(True, nproc=8, total_bytes=4 * m.MiB, seed=4),
    "hpio-cnc": lambda m: m.hpio(False, nproc=8, total_bytes=4 * m.MiB, seed=5),
    "tile-1d": lambda m: m.mpi_tile_io(16, True, total_bytes=8 * m.MiB, seed=6),
    "tile-2d": lambda m: m.mpi_tile_io(16, False, total_bytes=8 * m.MiB, seed=7),
    "mixed-time": lambda m: m.mixed(
        m.relabel(m.ior("strided", 8, total_bytes=2 * m.MiB), 0, 0),
        m.relabel(m.ior("segmented-random", 8, total_bytes=2 * m.MiB, seed=9), 1, 1)),
    "mixed-burst": lambda m: m.mixed(
        m.relabel(m.ior("strided", 8, total_bytes=2 * m.MiB), 0, 0),
        m.relabel(m.ior("segmented-random", 8, total_bytes=2 * m.MiB, seed=9), 1, 1,
                  start_time=0.5),
        burst_requests=64, seed=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generators_equal_reference(case):
    a, b = CASES[case](port_w), CASES[case](ref_w)
    assert (a.name, a.total_bytes, a.nproc) == (b.name, b.total_bytes, b.nproc)
    assert np.array_equal(_cols(a), _cols(b))


def test_unknown_pattern_raises():
    with pytest.raises(ValueError):
        port_w.ior("diagonal", 4)


WAVES = {
    "default-knobs": dict(nproc=4, waves=2, bytes_per_wave=4 * 1024 * 1024),
    "rotating": dict(nproc=8, waves=5, bytes_per_wave=8 * 1024 * 1024, rotate_files=3,
                     file_id=10, app_id=2, compute_seconds=2.5, seed=7),
    "one-wave": dict(nproc=16, waves=1, bytes_per_wave=16 * 1024 * 1024,
                     request_size=64 * 1024, seed=1),
}


def _items(w):
    return [(type(r).__name__, getattr(r, "seconds", None)) if not hasattr(r, "offset")
            else (r.offset, r.size, r.file_id, r.app_id, r.time) for r in w.trace]


@pytest.mark.parametrize("case", sorted(WAVES))
def test_checkpoint_wave_equals_reference(case):
    a, b = port_w.checkpoint_wave(**WAVES[case]), ref_w.checkpoint_wave(**WAVES[case])
    assert (a.name, a.total_bytes, a.nproc) == (b.name, b.total_bytes, b.nproc)
    assert _items(a) == _items(b)


@pytest.mark.parametrize("bad", [dict(waves=0), dict(rotate_files=0)])
def test_checkpoint_wave_rejects_what_the_reference_rejects(bad):
    for mod in (port_w, ref_w):
        with pytest.raises(ValueError):
            mod.checkpoint_wave(4, **bad)


@pytest.mark.parametrize("policy", ["round-robin-app", "hash-file", "range-offset"])
@pytest.mark.parametrize("dead", [(), (3,), (0, 5), (1, 2, 4, 6, 7)])
def test_reshard_to_survivors_equals_reference(policy, dead):
    from repro.distributed import sharding as ref_s
    from repro_torch.distributed import sharding as port_s

    rng = np.random.default_rng(len(dead) * 7 + len(policy))
    n, nodes = 500, 8
    offs = rng.integers(0, 1 << 36, n).astype(np.int64)
    fids = rng.integers(0, 12, n).astype(np.int64)
    aids = rng.integers(0, 5, n).astype(np.int64)
    assign = port_s.assign_nodes(policy, offs, fids, aids, nodes)
    survivors = [s for s in range(nodes) if s not in dead][::-1]  # any order
    got = port_s.reshard_to_survivors(policy, offs, fids, aids, assign, survivors)
    want = ref_s.reshard_to_survivors(policy, offs, fids, aids, assign, survivors)
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert not np.isin(got, dead).any()
    assert np.array_equal(got[~np.isin(assign, dead)], assign[~np.isin(assign, dead)])
    assert np.array_equal(port_s.reshard_to_survivors(policy, offs, fids, aids, got,
                                                      survivors), got)  # idempotent


def test_reshard_to_no_survivors_raises():
    from repro_torch.distributed.sharding import reshard_to_survivors

    with pytest.raises(ValueError):
        reshard_to_survivors("hash-file", [0], [0], [0], [0], [])
