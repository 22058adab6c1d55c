"""The port's ``TraceBatch``, sharding and ``compute_stream_scores`` against
the reference's, on the same columns.

``backend="kernel"`` on ``device="cpu"`` runs the kernel's plain torch
version over the padded stream matrix; it must equal the reference's
``backend="numpy"`` oracle on every field, bit for bit, with no 2 GiB
fallback: golden traces, ragged tails and offsets up to 2^38.
"""

import numpy as np
import pytest
import torch

from repro.core import TraceBatch as RefTraceBatch
from repro.core import compute_stream_scores as ref_scores
from repro.distributed.sharding import assign_nodes as ref_assign
from repro.testing.traces import golden_trace as ref_golden_trace
from repro_torch.core import TraceBatch, compute_stream_scores
from repro_torch.core.trace import _score_shards_kernel
from repro_torch.distributed.sharding import TRACE_POLICIES, assign_nodes

COLUMNS = ("offsets", "sizes", "file_ids", "app_ids", "times",
           "gap_positions", "gap_seconds")
SCORE_FIELDS = ("rf_sum", "percentage", "seek_distance", "nbytes", "offset_sum")


def _port(batch: RefTraceBatch) -> TraceBatch:
    return TraceBatch.from_numpy(**{c: getattr(batch, c) for c in COLUMNS})


def _bench_trace(n: int, seed: int = 0) -> RefTraceBatch:
    """The replay benchmark's trace family: 64 KiB requests, offsets
    uniform in [0, 2^38), 16 files, 8 apps, one mid-trace gap."""

    rng = np.random.default_rng(seed)
    return RefTraceBatch(
        offsets=rng.integers(0, 1 << 38, size=n).astype(np.int64),
        sizes=np.full(n, 64 << 10, dtype=np.int64),
        file_ids=rng.integers(0, 16, size=n).astype(np.int64),
        app_ids=rng.integers(0, 8, size=n).astype(np.int64),
        times=np.zeros(n),
        gap_positions=np.asarray([n // 2], dtype=np.int64),
        gap_seconds=np.asarray([30.0]),
    )


def _ragged(n: int, seed: int) -> RefTraceBatch:
    """Ties of differing sizes and a ragged tail of ``n % 128`` requests."""

    rng = np.random.default_rng(seed)
    return RefTraceBatch(
        offsets=(rng.integers(0, 64, size=n) * 4096).astype(np.int64),
        sizes=(rng.integers(0, 3, size=n) * 4096).astype(np.int64),
        file_ids=np.zeros(n, dtype=np.int64),
        app_ids=rng.integers(0, 3, size=n).astype(np.int64),
        times=np.zeros(n),
        gap_positions=np.asarray([0, n // 3, n], dtype=np.int64),
        gap_seconds=np.asarray([1.0, 2.0, 3.0]),
    )


TRACES = {
    "mixed-burst": lambda: ref_golden_trace("mixed-burst"),
    "strided-gaps": lambda: ref_golden_trace("strided-gaps"),
    "ragged-1": lambda: _ragged(129, 1),
    "ragged-2": lambda: _ragged(258, 2),
    "ragged-37": lambda: _ragged(1061, 3),
    "bench-2^38": lambda: _bench_trace(20_000),
}


@pytest.fixture(scope="module")
def traces():
    return {k: build() for k, build in TRACES.items()}


@pytest.mark.parametrize("name", TRACES)
def test_stream_views_equal_reference(traces, name):
    ref = traces[name]
    port = _port(ref)
    for a, b in zip(port.padded_stream_matrix(), ref.padded_stream_matrix()):
        assert np.array_equal(a, b)
    for a, b in zip(port.stream_sums(), ref.stream_sums()):
        assert np.array_equal(a, b)
    for a, b in zip(port.stream_matrix(), ref.stream_matrix()):
        assert np.array_equal(a, b)
    assert np.array_equal(port.stream_bounds(), ref.stream_bounds())
    assert port.total_bytes == ref.total_bytes


@pytest.mark.parametrize("policy", sorted(TRACE_POLICIES))
@pytest.mark.parametrize("name", TRACES)
def test_shards_equal_reference(traces, name, policy):
    ref = traces[name]
    port = _port(ref)
    args = (ref.offsets, ref.file_ids, ref.app_ids, 5)
    assignment = assign_nodes(policy, *args)
    assert np.array_equal(assignment, ref_assign(policy, *args))
    for a, b in zip(port.shard(assignment, 5), ref.shard(assignment, 5)):
        for c in COLUMNS:
            assert np.array_equal(getattr(a, c), getattr(b, c)), c


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("name", TRACES)
def test_scores_equal_numpy_oracle(traces, name, backend):
    ref = traces[name]
    want = ref_scores(ref, backend="numpy")
    got = compute_stream_scores(_port(ref), backend=backend, device="cpu")
    for f in SCORE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.backend == backend


def test_scores_need_a_device_without_cuda(monkeypatch):
    """The kernel backend runs on the card unless told otherwise."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = _port(_ragged(300, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_stream_scores(batch)
    compute_stream_scores(batch, backend="numpy")  # the host oracle needs none


def test_from_numpy_and_from_items_agree():
    ref = ref_golden_trace("strided-gaps")
    items = ref.to_items()
    from repro_torch.core import Gap, Request

    port_items = [Gap(i.seconds) if type(i).__name__ == "Gap" else
                  Request(i.offset, i.size, i.file_id, i.app_id, i.time)
                  for i in items]
    a, b = TraceBatch.from_items(port_items), _port(ref)
    for c in COLUMNS:
        assert np.array_equal(getattr(a, c), getattr(b, c)), c
        assert getattr(a, c).dtype == getattr(b, c).dtype


def test_bad_backend_and_columns_raise():
    with pytest.raises(ValueError):
        compute_stream_scores(_port(_ragged(10, 5)), backend="pallas")
    with pytest.raises(ValueError):
        TraceBatch.from_numpy(offsets=[1], sizes=[1], file_ids=[0],
                              app_ids=[0], colour=[1])


# -- one launch for all shards -------------------------------------------

SHARD_CASES = {  # trace, nodes: full streams, tail-only shards, empty shards
    "bench-2^38": ("bench-2^38", 7),
    "ragged-37": ("ragged-37", 5),
    "ragged-1": ("ragged-1", 5),  # every shard is a tail (26 requests)
    "short": ("short", 8),  # 3 requests: most shards are empty
}


def _shard_case(traces, name):
    trace, nodes = SHARD_CASES[name]
    ref = traces[trace] if trace in traces else _ragged(3, 9)
    return _port(ref), nodes


@pytest.mark.parametrize("policy", sorted(TRACE_POLICIES))
@pytest.mark.parametrize("name", SHARD_CASES)
def test_one_launch_equals_scoring_each_shard(traces, name, policy):
    batch, nodes = _shard_case(traces, name)
    shards = batch.shard(assign_nodes(policy, batch.offsets, batch.file_ids,
                                      batch.app_ids, nodes), nodes)
    shards.append(batch.select(np.zeros(0, dtype=np.int64)))  # an empty shard
    got = _score_shards_kernel(shards, 128, torch.device("cpu"))
    assert len(got) == len(shards)
    for shard, g in zip(shards, got):
        want = compute_stream_scores(shard, device="cpu")
        oracle = compute_stream_scores(shard, backend="numpy")
        for f in SCORE_FIELDS:
            a = getattr(g, f)
            assert a.dtype == getattr(want, f).dtype
            assert np.array_equal(a, getattr(want, f)), f
            assert np.array_equal(a, getattr(oracle, f)), f
        assert g.backend == "kernel" and g.stream_len == 128


@pytest.mark.parametrize("stream_len", [2, 32, 256])
def test_one_launch_mixed_lengths_and_no_rows(stream_len):
    """Shards with full streams, a tail alone, a trace shorter than one
    stream, and none at all; also the call with no rows anywhere."""

    port = _port(_ragged(5 * stream_len + 3, 11))
    shards = [port, port.select(np.arange(stream_len - 1)),
              port.select(np.zeros(0, dtype=np.int64)),
              port.select(np.arange(1, 2 * stream_len + 1))]
    got = _score_shards_kernel(shards, stream_len, torch.device("cpu"))
    for shard, g in zip(shards, got):
        want = compute_stream_scores(shard, stream_len, backend="numpy")
        for f in SCORE_FIELDS:
            assert np.array_equal(getattr(g, f), getattr(want, f)), f
    empty = _score_shards_kernel(shards[2:3] * 2, stream_len, torch.device("cpu"))
    assert [g.rf_sum.shape for g in empty] == [(0,), (0,)]


def test_fleet_program_scores_all_shards_in_one_call(monkeypatch):
    """The first sweep scores every shard with one ``stream_stats_op``
    call; its tapes equal tapes from scoring each shard alone."""

    from repro_torch.core import FleetProgram
    from repro_torch.core import engine_device as ed
    from repro_torch.kernels.stream_rf import ops

    calls, lens = [], []
    real = ops.stream_stats_op

    def counted(offsets, sizes, lengths=None):
        calls.append(tuple(offsets.shape))
        lens.append(lengths)
        return real(offsets, sizes, lengths)

    monkeypatch.setattr(ops, "stream_stats_op", counted)
    batch = _port(ref_golden_trace("mixed-burst"))
    prog = FleetProgram(num_nodes=5, policy="range-offset", device="cpu")
    shards = prog.shard(batch)
    prog.run(batch)
    rows = sum(s.padded_stream_matrix()[0].shape[0] for s in shards)
    assert calls == [(rows, 128)]
    # the shards' ragged tails are padded score-neutrally: no true lengths
    assert lens == [None]
    prog.run(batch)  # tapes are cached: no second scoring
    assert len(calls) == 1
    for shard, tape in zip(shards, prog._tape_cache[1]):
        alone = ed.build_events(shard, compute_stream_scores(shard, backend="numpy"))
        assert tape.keys() == alone.keys()
        for k in tape:
            assert np.array_equal(tape[k], alone[k]), k
