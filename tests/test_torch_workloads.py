"""The port's workload generators reproduce the reference's traces to the
byte: the golden fixtures' stored fingerprints, and the generators'
columns for a spread of patterns."""

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
