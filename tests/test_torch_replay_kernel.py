"""The ``replay`` kernel's contract and algorithm, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/replay/csrc/replay.cu``) runs
only on a card; ``tests/test_torch_on_card.py`` holds it to its plain torch
version there.  Here:

* (a) the packed layout: every field table of ``ops`` equals the enum the
  ``.cu`` source declares (parsed from its text), the ctypes binding takes
  as many arguments as the C entry point, and packing round-trips a
  golden trace's stacked tape, lane constants and state (values and the
  plain version's dtypes);
* (b) a lane-serial NumPy mirror of the kernel's algorithm
  (``repro_torch.testing.replay_serial``) against ``replay_lanes`` on the
  CPU, on the golden fixtures' sweeps and the live-reference cases of
  ``tests/test_torch_engine_device.py`` (built with the port's host half,
  which equals the reference's) and a sweep long enough to wrap the
  window.  Both take the same IEEE float64 operations in the same order,
  so every field is compared exactly, NaN included;
* (c) ``replay_op`` refuses what the kernel does not take.
"""

import dataclasses
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import FleetProgram, compute_stream_scores
from repro_torch.core import engine_device as ed
from repro_torch.core.device_model import HDDModel, InterferenceModel, make_storage_model
from repro_torch.distributed.sharding import assign_nodes
from repro_torch.kernels.replay import kernel, ops, ref
from repro_torch.testing import golden
from repro_torch.testing.replay_serial import candidates, replay_serial, threshold_pass
from repro_torch.testing.traces import golden_trace, sweep_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (REPO / "src" / "repro_torch" / "kernels" / "replay" / "csrc" / "replay.cu").read_text()
SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
G = ed._globals(HDDModel(), InterferenceModel())


# -- (a) the packed layout ------------------------------------------------


def _constants() -> dict[str, int]:
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr (?:int|long long) (\w+) = ([^;]+);", SOURCE):
        consts[name] = eval(expr.replace("LL", ""), {}, dict(consts))
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


@pytest.mark.parametrize("struct,table", [
    ("TapeF64", ops.TAPE_F64), ("TapeI64", ops.TAPE_I64), ("TapeU8", ops.TAPE_U8),
    ("LaneF64", ops.LANE_F64), ("LaneI64", ops.LANE_I64), ("StateF64", ops.STATE_F64),
    ("StateI64", ops.STATE_I64), ("OutF64", ops.OUT_F64), ("OutI64", ops.OUT_I64),
])
def test_field_tables_equal_the_source(struct, table):
    assert tuple(_enum_fields(struct)) == table


def test_globals_and_limits_equal_the_source():
    members = re.search(r"struct Globals \{\s*double ([^;]+);", SOURCE).group(1)
    assert tuple(m.strip() for m in members.split(",")) == ops.GLOBALS
    consts = _constants()
    assert consts["MAX_WINDOW"] == ops.MAX_WINDOW and consts["MAX_FILLS"] == ops.MAX_FILLS
    assert consts["TAPE_ALIGN"] == ops.TAPE_ALIGN
    assert (consts["SUFFIX_ANCHORS"], consts["N_WINDOWS"], consts["XMERGE_D"]) == \
        (ref.SUFFIX_ANCHORS, ref.N_WINDOWS, ref.XMERGE_D)


def test_binding_matches_the_c_entry_point():
    sig = re.search(r'extern "C" int replay_launch\((.*?)\)', SOURCE, re.S).group(1)
    params = [" ".join(p.split()[:-1]) for p in sig.replace("\n", " ").split(",")]

    class Fn:
        argtypes = restype = None

    class Lib:
        replay_launch = Fn()

    kernel._bind(Lib)
    want = {"const void*": "c_void_p", "void*": "c_void_p", "double": "c_double", "int": "c_int"}
    assert [t.__name__ for t in Lib.replay_launch.argtypes] == [want[p] for p in params]
    # the packed parts and the two outputs, the globals, (S, L, W, steps), the stream
    assert len(params) == len(dataclasses.fields(ops.Packed)) + 2 + len(ops.GLOBALS) + 4 + 1


def _fleet_inputs(wl: str, policy: str, ssd=None, cap=None):
    """One golden program's stacked tape, lane constants and state, as
    ``FleetProgram`` builds them (lanes scheme-major)."""

    batch = golden_trace(wl)
    prog = FleetProgram(num_nodes=golden.FIXTURE_NODES, schemes=golden.FIXTURE_SCHEMES,
                        policy=policy, ssd=ssd,
                        ssd_capacity=cap or golden._node_capacity(batch.total_bytes),
                        device="cpu")
    tapes, _ = prog._tapes(batch)
    n = prog.num_nodes
    return (ed.stack_events([tapes[i] for _ in prog.schemes for i in range(n)]),
            ed._stack_lanes([ed.lane_consts(s, prog.ssd_capacity, prog.flush_gate,
                                            ssd=prog.ssd)
                             for s in prog.schemes for _ in range(n)]),
            ed._stack_lanes([ed.initial_lane_state(s, prog.adaptive_window, ssd=prog.ssd)
                             for s in prog.schemes for _ in range(n)]))


@pytest.mark.parametrize("ssd", [None, "ftl"])
@pytest.mark.parametrize("wl", golden.FIXTURE_WORKLOADS)
def test_packing_round_trips(wl, ssd):
    events, lanes, state0 = _fleet_inputs(wl, "round-robin-app", ssd=ssd)
    # a stacked length that is not a multiple of TAPE_ALIGN: the packed tape
    # pads it with invalid, zero events
    s, l = events["valid"].shape
    events = ed.stack_events([{k: v[:, j] for k, v in events.items()} for j in range(l)],
                             pad_to=s + 3)
    buf, shape = ops.pack(events, lanes, state0)
    assert shape == (ops.padded_len(s + 3), l, state0["win"].shape[1])
    assert shape[0] % ops.TAPE_ALIGN == 0 and shape[0] > s + 3
    p = ops.views(torch.from_numpy(buf), *shape)
    for got, want in zip(ops.unpack(p), (events, lanes, state0)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            t = torch.tensor(np.asarray(v))  # the dtype the plain version was given
            rows = got[k][:s + 3] if k in events else got[k]
            assert rows.dtype == t.dtype and torch.equal(rows, t), k
            if k in events:
                assert not got[k][s + 3:].any(), k
    np_views = ops.views(buf, *shape)
    assert np_views.tape_f64.shape == (len(ops.TAPE_F64), l, shape[0])
    # one lane's events lie contiguous, field by field, each row on 16 bytes
    assert np_views.tape_f64[ops.TAPE_F64.index("pct"), 1, :s + 3].tolist() == \
        events["pct"][:, 1].tolist()
    for part in (np_views.tape_f64, np_views.tape_i64, np_views.tape_u8):
        assert (part.ctypes.data - buf.ctypes.data) % 16 == 0
        assert part.strides[1] % 16 == 0 and part.strides[2] == part.itemsize
    assert np.shares_memory(np_views.win, buf)


# -- (b) the kernel's algorithm, lane by lane --------------------------------


def _serial_vs_plain(events, lanes, state0) -> dict:
    want = ed.replay_lanes(events, lanes, state0, device="cpu")
    buf, shape = ops.pack(events, lanes, state0)
    rows = np.nonzero(events["valid"].any(axis=1))[0]
    steps = int(rows[-1]) + 1 if rows.size else 0
    got = replay_serial(ops.views(buf, *shape), [G[k] for k in ops.GLOBALS], steps)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k], equal_nan=True), \
            (k, got[k][got[k] != want[k]], want[k][got[k] != want[k]])
    return got


FIXTURES = [(s, w, p) for s in golden.FIXTURE_SCHEMES
            for w in golden.FIXTURE_WORKLOADS for p in golden.FIXTURE_POLICIES]


@pytest.mark.parametrize("scheme,workload,policy", FIXTURES,
                         ids=["__".join(f) for f in FIXTURES])
def test_serial_mirror_equals_plain_on_golden_fixture(scheme, workload, policy):
    events, lanes, state0 = _fleet_inputs(workload, policy)
    n = golden.FIXTURE_NODES
    lo = golden.FIXTURE_SCHEMES.index(scheme) * n
    pick = slice(lo, lo + n)
    _serial_vs_plain({k: v[:, pick] for k, v in events.items()},
                     {k: v[pick] for k, v in lanes.items()},
                     {k: v[pick] for k, v in state0.items()})


def _sweep(batch, policy, nodes, cap, gate=0.5, warmup=None, ssd=None, window=64):
    a = assign_nodes(policy, batch.offsets, batch.file_ids, batch.app_ids, nodes)
    tapes = [ed.build_events(s, compute_stream_scores(s, device="cpu"), ssd=ssd)
             for s in batch.shard(a, nodes)]
    return (ed.stack_events([tapes[n] for _ in SCHEMES for n in range(nodes)]),
            ed._stack_lanes([ed.lane_consts(s, cap, gate, ssd=ssd)
                             for s in SCHEMES for _ in range(nodes)]),
            ed._stack_lanes([ed.initial_lane_state(s, window, warmup, ssd=ssd)
                             for s in SCHEMES for _ in range(nodes)]))


def _case(name: str):
    """The live-reference cases of ``tests/test_torch_engine_device.py``
    (mixed-burst, strided-gaps, warm-up, FTL, the anomaly's three gates),
    and cases that reach further: adaptive windows of 1 and 7, and a
    150,000-request sweep (297 events a lane: the window of 64 wraps), with
    the constant SSD, with the FTL, and at a window of 7 with the device
    gate."""

    mb, sg = golden_trace("mixed-burst"), golden_trace("strided-gaps")
    if name in ("mixed-burst", "strided-gaps"):
        b, policy = (mb, "range-offset") if name == "mixed-burst" else (sg, "round-robin-app")
        return _sweep(b, policy, 4, golden._node_capacity(b.total_bytes))
    if name.startswith("warmup"):
        warm = list(compute_stream_scores(mb, device="cpu").percentage[:40])
        window = {"warmup": 64, "warmup-w7": 7, "warmup-w1": 1}[name]
        return _sweep(mb, "round-robin-app", 4, golden._node_capacity(mb.total_bytes),
                      warmup=warm, window=window)
    if name == "ftl-mixed-burst":
        return _sweep(mb, "range-offset", 4, 4 << 20,
                      ssd=make_storage_model("ftl", logical_bytes=4 << 20))
    if name == "ftl-strided-gaps":
        cap = golden._node_capacity(sg.total_bytes)
        return _sweep(sg, "round-robin-app", 4, cap,
                      ssd=make_storage_model("ftl", logical_bytes=cap))
    if name.startswith("anomaly-gate"):
        with open(golden.GOLDEN_DIR / "anomaly_16n_straggler.json") as f:
            cap = json.load(f)["ssd_capacity"]
        _, shard = golden.load_anomaly_fixture()
        gate = name[len("anomaly-gate"):]
        return _sweep(shard, "range-offset", 1, cap,
                      gate=gate if gate == "device" else float(gate))
    sw = sweep_trace(150_000)
    if name == "sweep150k":
        return _sweep(sw, "range-offset", 4, max(sw.total_bytes // 2 // 4, 64 << 20))
    if name == "sweep150k-ftl":
        return _sweep(sw, "range-offset", 4, 64 << 20,
                      ssd=make_storage_model("ftl", logical_bytes=64 << 20))
    return _sweep(sw, "range-offset", 4, 32 << 20, window=7, gate="device")


CASES = ("mixed-burst", "strided-gaps", "warmup", "warmup-w7", "warmup-w1",
         "anomaly-gate0.5", "anomaly-gate0.75", "anomaly-gatedevice", "ftl-mixed-burst",
         "ftl-strided-gaps", "sweep150k", "sweep150k-ftl", "sweep150k-w7-device")


@pytest.mark.parametrize("case", CASES)
def test_serial_mirror_equals_plain(case):
    got = _serial_vs_plain(*_case(case))
    if case.startswith("ftl-"):  # GC fired in some lane
        assert got["ftl_reloc_pages"].max() > 0


@pytest.mark.parametrize("field", ["net_t", "hddt_0"])
def test_serial_mirror_carries_a_seeded_nan_to_the_clock(field):
    """A NaN in either operand of ``torch.maximum(net, dt)`` (the first
    stream goes to the HDD whole: anchor 0 is its time) reaches the clock,
    as the plain version carries it."""

    batch = golden_trace("strided-gaps")
    tape = ed.build_events(batch, compute_stream_scores(batch, device="cpu"))
    tape[field][0] = np.nan
    got = _serial_vs_plain(ed.stack_events([tape]),
                           ed._stack_lanes([ed.lane_consts("ssdup+", 1 << 26)]),
                           ed._stack_lanes([ed.initial_lane_state("ssdup+", 64)]))
    assert np.isnan(got["io_seconds"][0]) and np.isnan(got["total_seconds"][0])


def _plain_thresholds(pcts, win0, win_n, win_p) -> np.ndarray:
    """The plain version's ``adap_thr`` at each stream event of one SSDUP+
    lane (``ref._adaptive_threshold``, which ``ref._observe_and_route``
    reads), stepped one event at a time."""

    win = torch.tensor(np.asarray(win0, dtype=np.float64))[None]
    n, pos = torch.tensor([win_n], dtype=torch.int32), torch.tensor([win_p], dtype=torch.int32)
    out = []
    for v in pcts:
        thr, win, n, pos = ref._adaptive_threshold(
            win, n, pos, torch.tensor([v], dtype=torch.float64), G["default_thr"])
        out.append(float(thr[0]))
    return np.array(out)


def _window_case(w: int, filled: int, events: int, seed: int, nan_at=(), ties=False):
    """A seeded window of ``w`` slots whose first ``filled`` hold percentages
    (the rest the +inf pads, as ``initial_lane_state`` leaves them) and
    ``events`` stream percentages after it, drawn from eight values where
    ``ties`` (so equal keys meet in the sort), with NaN at ``nan_at``."""

    rng = np.random.default_rng(seed)
    draw = (lambda n: rng.integers(0, 8, n) / 8.0) if ties else (lambda n: rng.random(n))
    win0 = np.full(w, np.inf)
    win0[:filled] = draw(filled)
    pcts = draw(events)
    pcts[list(nan_at)] = np.nan
    return pcts, win0, filled, filled % w


def _same_bits(got, want) -> None:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    bad = ~((got == want) | (np.isnan(got) & np.isnan(want)))
    assert not bad.any(), (np.nonzero(bad)[0][:5], got[bad][:5], want[bad][:5])
    # the same value, not only equal: -0.0 and 0.0 kept apart
    assert np.array_equal(np.signbit(got), np.signbit(want))


THRESHOLD_CASES = {
    # W = 1: one slot, every event replaces it
    "w1-empty": (1, 0, 150, 1), "w1-full": (1, 1, 150, 2),
    # W = 64: the sweep's window, chunks of 64 events, through three chunks
    "w64-empty": (64, 0, 300, 3), "w64-part": (64, 40, 300, 4), "w64-full": (64, 64, 300, 5),
    # W = 1,024, the largest: chunks of 1,024 events, past one chunk's end
    "w1024-empty": (1024, 0, 1100, 6), "w1024-part": (1024, 700, 1100, 7),
    "w1024-full": (1024, 1024, 1100, 8),
}


@pytest.mark.parametrize("case", list(THRESHOLD_CASES))
def test_threshold_pass_equals_plain_adap_thr(case):
    """The kernel's threshold pass (mirrored by ``threshold_pass``) against
    the plain version's ``adap_thr`` event by event, bit for bit: windows of
    1, 64 and 1,024 slots, empty, partly filled (the +inf pads in the sum
    and the pick) and full, over several chunks of the pass."""

    w, filled, events, seed = THRESHOLD_CASES[case]
    pcts, win0, n0, p0 = _window_case(w, filled, events, seed)
    _same_bits(threshold_pass(pcts, win0, n0, p0, G["default_thr"]),
               _plain_thresholds(pcts, win0, n0, p0))


@pytest.mark.parametrize("w,filled", [(1, 1), (7, 3), (64, 0), (64, 64), (1024, 1024)])
def test_threshold_pass_equals_plain_with_ties_and_nan(w, filled):
    """Tied percentages (eight values: equal keys meet in the bitonic sort
    and at the picked index) and two seeded NaN percentages, which sort
    after +inf: while one is among a window's first entries the mean is
    NaN and the pick falls to index 0 (with one slot, the NaN itself)."""

    events = 3 * candidates(w) - 2 * w if w < 1024 else 1100
    pcts, win0, n0, p0 = _window_case(w, filled, events, 11 + w, nan_at=(5, 90), ties=True)
    got = threshold_pass(pcts, win0, n0, p0, G["default_thr"])
    want = _plain_thresholds(pcts, win0, n0, p0)
    _same_bits(got, want)
    clean = pcts.copy()
    clean[[5, 90]] = 0.5
    assert not np.array_equal(want, _plain_thresholds(clean, win0, n0, p0), equal_nan=True)
    assert np.isnan(want[5]) == (w == 1)


def test_threshold_pass_from_a_window_written_midway():
    """A full window whose next write slot is not 0 and holds the +inf pads
    in the middle (a window carried over from an earlier replay)."""

    rng = np.random.default_rng(21)
    win0 = rng.random(64)
    win0[10:20] = np.inf
    pcts = rng.random(200)
    _same_bits(threshold_pass(pcts, win0, 64, 37, G["default_thr"]),
               _plain_thresholds(pcts, win0, 64, 37))


def test_ssdup_lane_does_not_depend_on_its_window():
    """SSDUP routes by its static watermarks: its lanes' outputs are the
    same whatever their adaptive window holds (the kernel keeps none), in
    the plain version and in the mirror; an SSDUP+ lane's do depend on it."""

    events, lanes, state0 = _case("warmup-w7")
    other = {k: v.copy() for k, v in state0.items()}
    rng = np.random.default_rng(5)
    other["win"] = rng.random(other["win"].shape)
    other["win_n"][:] = other["win"].shape[1]
    other["win_p"][:] = 3
    a, b = _serial_vs_plain(events, lanes, state0), _serial_vs_plain(events, lanes, other)
    ssdup = lanes["scheme"] == ed.SCHEME_IDS["ssdup"]
    plus = lanes["scheme"] == ed.SCHEME_IDS["ssdup+"]
    for k in a:
        assert np.array_equal(a[k][ssdup], b[k][ssdup], equal_nan=True), k
    assert any(not np.array_equal(a[k][plus], b[k][plus]) for k in a)


@pytest.mark.parametrize("name", ["nohdd", "nofill", "nothreshold"])
def test_timing_ablations_apply_to_todays_source(name):
    """``chip_replay_compare.py --ablate`` makes each ablation by editing the
    text of ``replay.cu``; every edit must still fit the source once (one
    that no longer does raises ``SystemExit`` there, on the card)."""

    spec = importlib.util.spec_from_file_location("chip_replay_compare",
                                                  REPO / "chip_replay_compare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.ABLATIONS) == {"nohdd", "nofill", "nothreshold"}
    text = mod.ablated_source(SOURCE, name)
    assert text != SOURCE
    for old, new in mod.ABLATIONS[name]:
        assert old not in text and new in text


# -- (c) what the wrapper refuses ----------------------------------------


def _packed(window: int = 8) -> tuple[ops.Packed, list, int]:
    batch = golden_trace("mixed-burst")
    tape = ed.build_events(batch, compute_stream_scores(batch, device="cpu"))
    events = ed.stack_events([tape])
    buf, shape = ops.pack(events, ed._stack_lanes([ed.lane_consts("ssdup+", 1 << 26)]),
                          ed._stack_lanes([ed.initial_lane_state("ssdup+", window)]))
    return ops.views(torch.from_numpy(buf), *shape), [G[k] for k in ops.GLOBALS], shape[0]


def test_replay_op_runs_the_plain_version_on_the_cpu():
    p, g, s = _packed()
    ops.reset_launches()
    out = ops.replay_op(p, g, s)
    assert tuple(out) == ref.OUTPUTS and ops.launches["replay"] == 0
    assert out["flushes"].dtype == torch.int32 and out["io_seconds"].dtype == torch.float64


def test_replay_op_refuses_a_window_above_its_maximum():
    p, g, s = _packed(ops.MAX_WINDOW + 1)
    with pytest.raises(ValueError, match="window"):
        ops.replay_op(p, g, s)
    p, g, s = _packed(ops.MAX_WINDOW)  # the largest it takes
    ops.replay_op(p, g, s)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "steps", "globals",
                                 "tensor"])
def test_replay_op_refuses_what_the_kernel_does_not_take(bad):
    p, g, s = _packed()
    exc = TypeError if bad == "dtype" else ValueError
    if bad == "dtype":
        p = dataclasses.replace(p, lane_f64=p.lane_f64.float())
    elif bad == "shape":
        p = dataclasses.replace(p, state_i64=p.state_i64[:-1])
    elif bad == "contiguity":
        p = dataclasses.replace(p, win=p.win.repeat(1, 2)[:, ::2])
    elif bad == "steps":
        s += 1
    elif bad == "globals":
        g = g[:-1]
    else:
        p = dataclasses.replace(p, tape_u8=p.tape_u8.numpy())
    with pytest.raises(exc):
        ops.replay_op(p, g, s)
