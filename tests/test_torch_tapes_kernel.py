"""The ``tapes`` kernel's contract and algorithm, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/tapes/csrc/tapes.cu``) runs
only on a card; ``tests/test_torch_on_card.py`` holds it to the plain
version there, on the cases of ``tapes_cases.py``, and
``test_torch_tapes_reference.py`` holds the port's tapes to the reference
package's on the same cases.  Here:

* (a) the layout: the ``.cu``'s input and output tables and its constants
  equal the Python tuples (parsed from its text), its limits equal the
  Python's, and the ctypes binding matches the C entry point;
* (b) the kernel's algorithm (``tapes_kernel_model.py``: the SSD wall in
  NumPy's pairwise order, sorted runs a stream, one walker a mask, merge
  rounds of the shard's order, the kernel step for step) against the
  plain version (``kernels/tapes/ref.py``, the host tape builder's
  lexsorts and bincounts), bit for bit, on the paper's IOR runs and on
  shards made to reach every branch: interleaved files, duplicate and
  overlapping offsets with ties across streams, offsets over the whole
  int64 range, a partial trailing stream, stream lengths 2 to 8,192,
  compute gaps, and an empty shard, which no version takes; and its
  pairwise sum against ``np.add.reduceat`` at every length up to 300 and
  beyond;
* (c) ``build_events``: the columns placed in the tape's stream rows,
  counted on the CPU as no launch and no read-back; the shapes the kernel
  refuses have their columns on the CPU and count ``tapes.host``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import tapes_kernel_model as model
from repro_torch import tracing
from repro_torch.core import FleetProgram, compute_stream_scores
from repro_torch.core import engine_device as ed
from repro_torch.kernels.tapes import kernel, ops, ref
from tapes_cases import CASES, CONSTS, _mixed, numpy_columns, same_bits, same_tape, \
    shard_cols, tape_case

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (REPO / "src" / "repro_torch" / "kernels" / "tapes" / "csrc" / "tapes.cu").read_text()


@pytest.fixture(autouse=True)
def clean():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


# -- (a) the layout ----------------------------------------------------------


def _constants() -> dict[str, int]:
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE):
        consts[name] = eval(expr, {}, dict(consts))
    return consts


def _enum_fields(struct: str) -> list[str]:
    """The field names a ``struct X { enum : int { ... }; };`` of the source
    lays out: a member ``NAME_0`` or ``NAME_1`` starts a group that runs to
    the next member, ``COUNT`` ends the table."""

    body = re.search(r"struct %s \{ enum : int \{(.*?)\}; \};" % struct, SOURCE, re.S)
    assert body, struct
    scope, value, members = dict(_constants()), -1, []
    for item in (m.strip() for m in body.group(1).split(",")):
        if not item:
            continue
        name, _, expr = (s.strip() for s in item.partition("="))
        value = eval(expr, {}, scope) if expr else value + 1
        scope[name] = value
        members.append((name, value))
    assert members[-1][0] == "COUNT"
    fields = []
    for (name, v), (_, nxt) in zip(members, members[1:]):
        group = re.fullmatch(r"(\w+)_([01])", name)
        if nxt - v > 1 or group:
            assert group, name
            fields += [f"{group[1].lower()}_{int(group[2]) + k}" for k in range(nxt - v)]
        else:
            fields.append(name.lower())
        assert len(fields) == nxt
    return fields


@pytest.mark.parametrize("struct,table", [("Col", ops.INPUTS), ("Column", ops.COLUMNS)])
def test_tables_equal_the_source(struct, table):
    assert tuple(_enum_fields(struct)) == table


def test_constants_equal_the_source():
    members = re.search(r"struct Consts \{\s*double ([^;]+);", SOURCE).group(1)
    assert tuple(m.strip() for m in members.split(",")) == ops.CONSTS


def test_limits_equal_the_source():
    consts = _constants()
    assert consts["MAX_STREAM_LEN"] == ops.MAX_STREAM_LEN
    assert (consts["SUFFIX_ANCHORS"], consts["N_WINDOWS"], consts["XMERGE_D"]) == \
        (ref.SUFFIX_ANCHORS, ref.N_WINDOWS, ref.XMERGE_D)
    # a block keeps five arrays of its stream: three int64, two uint16
    assert ops.MAX_STREAM_LEN * (3 * 8 + 2 * 2) <= 232_448


def test_binding_matches_the_c_entry_point():
    sig = re.search(r'extern "C" int tapes_launch\((.*?)\)', SOURCE, re.S).group(1)
    params = [" ".join(p.split()[:-1]) for p in sig.replace("\n", " ").split(",")]

    class Fn:
        argtypes = restype = None

    class Lib:
        tapes_launch = Fn()

    kernel._bind(Lib)
    want = {"const void*": "c_void_p", "void*": "c_void_p", "double": "c_double", "int": "c_int"}
    assert [t.__name__ for t in Lib.tapes_launch.argtypes] == [want[p] for p in params]
    # the columns, (n, L), the scratch, the output, the constants, the stream
    assert len(params) == 1 + 2 + 2 + len(ops.CONSTS) + 1


# -- (b) the kernel's algorithm against the plain version ---------------------


@pytest.mark.parametrize("case", CASES)
def test_kernel_algorithm_equals_plain_version(case):
    shards, stream_len = tape_case(case)
    for batch in shards:
        if not batch.num_requests:
            assert case == "empty"
            with pytest.raises(ValueError, match="need a request"):
                ops.columns_op(shard_cols(batch), stream_len, CONSTS)
            continue
        want = ops.columns_op(shard_cols(batch), stream_len, CONSTS)
        assert want.dtype == torch.float64 and want.device.type == "cpu"
        got = model.columns(shard_cols(batch).numpy(), stream_len, *CONSTS)
        assert same_bits(got, want.numpy()) == []


@pytest.mark.parametrize("lengths", [range(1, 301), (511, 1024, 1031, 2048, 4099, 8192)],
                         ids=["1-300", "long"])
def test_pairwise_sum_is_the_order_reduceat_adds_in(lengths):
    """Each row's first value plus the pairwise sum of the rest equals
    ``np.add.reduceat`` bit for bit, on values across ten decades, where
    another order of additions rounds otherwise."""

    rng = np.random.default_rng(len(lengths))
    for n in lengths:
        x = rng.random((4, n)) * 10.0 ** rng.uniform(-5, 5, (4, n))
        want = np.add.reduceat(x.ravel(), np.arange(0, x.size, n))
        got = x[:, 0] + model.pairwise_sum(x[:, 1:]) if n > 1 else x[:, 0]
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), n
    assert not np.array_equal(np.cumsum(x, axis=1)[:, -1], want)


def test_the_cases_reach_every_column():
    """Every column reads nonzero in some case, and merges of streams
    1 and 2 apart in a shard of one file whose offsets repeat across
    streams (ties that the arrival order breaks)."""

    seen = np.zeros(len(ops.COLUMNS), dtype=bool)
    for case in ("files", "dups", "len96"):
        shards, stream_len = tape_case(case)
        for batch in shards:
            rows = numpy_columns(batch, stream_len)
            seen |= (rows != 0).any(axis=1)
    assert [k for k, s in zip(ops.COLUMNS, seen) if not s] == []
    dups, stream_len = tape_case("dups")
    one_file = numpy_columns(dups[0], stream_len)
    assert (one_file[ops.COLUMNS.index("xm_1"):ops.COLUMNS.index("xm_3")] != 0).any(axis=1).all()


@pytest.mark.parametrize("bad,err", [
    ((torch.zeros(3, 0, dtype=torch.int64), 128), ValueError),
    ((torch.zeros(3, 10, dtype=torch.int64), 0), ValueError),
    ((torch.zeros(2, 10, dtype=torch.int64), 128), ValueError),
    ((torch.zeros(3, 10, dtype=torch.int32), 128), TypeError),
    ((torch.zeros(10, 3, dtype=torch.int64).T, 128), ValueError),
    ((torch.zeros(3, 10, dtype=torch.int64, device="meta"), 128), ValueError),
])
def test_columns_op_refuses_what_no_version_takes(bad, err):
    with pytest.raises(err):
        ops.columns_op(*bad, CONSTS)
    assert tracing.counter("launch.tapes") == 0


def test_the_plain_version_takes_streams_above_the_kernels_limit():
    batch = _mixed(9000, 12, 2, False)
    stream_len = ops.MAX_STREAM_LEN + 1
    assert not ops.takes(batch.num_requests, stream_len)
    got = ops.columns_op(shard_cols(batch), stream_len, CONSTS).numpy()
    assert same_bits(got, model.columns(shard_cols(batch).numpy(), stream_len, *CONSTS)) == []


# -- (c) build_events ------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_build_events_places_the_columns_in_the_tape(case):
    """Each column in its field, at the streams' events (the gaps' are 0),
    the same tape on ``None`` and the CPU, and no launch, read-back or
    ``tapes.host`` counted on the CPU."""

    shards, stream_len = tape_case(case)
    for batch in shards:
        scores = compute_stream_scores(batch, stream_len, backend="numpy")
        got = ed.build_events(batch, scores, stream_len=stream_len, device="cpu")
        assert same_tape(ed.build_events(batch, scores, stream_len=stream_len), got) == []
        assert tracing.counters("tapes.") == {} and tracing.counter("launch.tapes") == 0
        assert tracing.counter("host_syncs") == 0 and tracing.counter("h2d_bytes") == 0
        streams = ~got["is_gap"]
        assert streams.sum() == -(-batch.num_requests // stream_len)
        assert got["is_gap"].sum() == len(batch.gap_positions)
        tape = np.stack([got[k] for k in ops.COLUMNS])
        assert not tape[:, ~streams].any()
        if batch.num_requests:
            assert same_bits(tape[:, streams], numpy_columns(batch, stream_len)) == []


def test_streams_above_the_kernels_limit_take_the_host_path():
    batch = _mixed(9000, 12, 2, False)
    stream_len = ops.MAX_STREAM_LEN + 1
    scores = compute_stream_scores(batch, stream_len, backend="numpy")
    got = ed.build_events(batch, scores, stream_len=stream_len, device="cuda")
    assert tracing.counters("tapes.") == {"tapes.host": 1}
    assert tracing.counter("launch.tapes") == 0
    assert same_tape(got, ed.build_events(batch, scores, stream_len=stream_len)) == []


def test_an_empty_shard_takes_the_host_path():
    batch = _mixed(0, 11, 1, False, gaps=2)
    scores = compute_stream_scores(batch, 128, backend="numpy")
    got = ed.build_events(batch, scores, device="cuda")
    assert tracing.counters("tapes.") == {"tapes.host": 1}
    assert tracing.counter("launch.tapes") == 0 and tracing.counter("host_syncs") == 0
    assert same_tape(got, ed.build_events(batch, scores)) == []
    assert got["is_gap"].all() and len(got["is_gap"]) == 2


def test_a_cpu_program_builds_its_tapes_in_numpy():
    shards, _ = tape_case("files")
    prog = FleetProgram(num_nodes=2, policy="range-offset", device="cpu")
    prog.run(shards[0])
    assert tracing.counter("tape_cache.miss") == 1
    assert tracing.counters("tapes.") == {} and tracing.counter("launch.tapes") == 0
