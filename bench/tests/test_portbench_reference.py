"""The benchmark's plain reference equals the port's sweep on the CPU, and
the comparison that decides ``correct`` catches a seeded fault."""

import json

import numpy as np
import pytest
import torch

from portbench_util import REPO, small_config  # noqa: F401  (puts the repo on sys.path)

from bench.harness import check
from bench.harness.cell import trace_seed
from bench.harness.registry import ROOT, load_module
from bench.reference import sweep as ref_sweep
from repro_torch.core.fleet import FleetProgram
from repro_torch.core.trace import TraceBatch

CONFIGS = ("ior-segrandom-2n", "ior-segcontig-2n")


def _cols(cfg, seed):
    gen = load_module(ROOT / "bench" / "generators" / f"{cfg['generator']}.py")
    return gen.generate(trace_seed(seed, 0), cfg["generator_args"])


def _port(cfg, cols):
    batch = TraceBatch.from_numpy(**cols)
    prog = FleetProgram(num_nodes=cfg["nodes"], schemes=tuple(cfg["schemes"]),
                        policy=cfg["policy"], stream_len=cfg["stream_len"],
                        ssd_capacity=ref_sweep.capacity(batch.total_bytes, cfg),
                        ssd=cfg["ssd"], adaptive_window=cfg["adaptive_window"],
                        flush_gate=cfg["flush_gate"], device="cpu")
    return batch, prog.run(batch)


@pytest.fixture(scope="module", params=[(c, s) for c in CONFIGS for s in (0, 2**31 + 5)],
                ids=lambda p: f"{p[0]}-seed{p[1]}")
def swept(request):
    name, seed = request.param
    cfg = small_config(name)
    cols = _cols(cfg, seed)
    batch, res = _port(cfg, cols)
    return cfg, batch, check.digest(res, cfg["schemes"]), ref_sweep.sweep(cols, cfg)


def test_reference_equals_the_port_bit_for_bit(swept):
    cfg, batch, d, ref = swept
    for f in check.INT_FIELDS + check.CLOCK_FIELDS:
        np.testing.assert_array_equal(d[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(d["total_bytes"], np.broadcast_to(ref["node_bytes"],
                                                                    d["total_bytes"].shape))
    assert check.compare(d, ref) == (0, 0.0)
    assert check.unconserved(d, batch.total_bytes) == 0


def test_the_sweep_exercises_both_devices(swept):
    cfg, _, d, ref = swept
    ssd = ref["bytes_to_ssd"].sum(axis=1)
    schemes = list(cfg["schemes"])
    assert ssd[schemes.index("orangefs")] == 0
    assert ssd[schemes.index("orangefs-bb")] > 0
    assert (ref["bytes_to_hdd_direct"].sum() > 0) and (ref["flushes"].sum() > 0)


def test_a_nudged_lane_is_caught(swept):
    cfg, _, d, ref = swept
    bad = {**d, "bytes_to_ssd": d["bytes_to_ssd"].copy()}
    bad["bytes_to_ssd"][2, 3] += 1
    assert check.compare(bad, ref)[0] == 1
    assert not check.verdict({"bytes_unconserved": 0, "int_mismatches": 1,
                              "clock_rel_gap": 0.0}, cfg["limits"])


def test_a_nudged_clock_is_caught(swept):
    cfg, _, d, ref = swept
    bad = {**d, "io_seconds": d["io_seconds"].copy()}
    bad["io_seconds"][1, 0] *= 1 + 1e-6
    gap = check.compare(bad, ref)[1]
    assert gap > cfg["limits"]["clock_rel_gap"]


@pytest.mark.parametrize("name", CONFIGS)
def test_a_dropped_request_is_caught(name, monkeypatch):
    cfg = small_config(name)
    cols = _cols(cfg, 3)
    orig = TraceBatch.shard

    def drop_one(self, assignment, num_nodes):
        shards = orig(self, assignment, num_nodes)
        keep = np.arange(1, shards[0].num_requests)
        return [shards[0].select(keep)] + shards[1:]

    monkeypatch.setattr(TraceBatch, "shard", drop_one)
    batch, res = _port(cfg, cols)
    d = check.digest(res, cfg["schemes"])
    assert check.unconserved(d, batch.total_bytes) == len(cfg["schemes"]) * int(cols["sizes"][0])
    assert check.compare(d, ref_sweep.sweep(cols, cfg))[0] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_the_float32_control_fails_the_clock_limit(name):
    """The control (the reference in float32, the next precision below
    what the configuration states) reads above the clock limit."""

    cfg = small_config(name)
    cols = _cols(cfg, 9)
    ref = ref_sweep.sweep(cols, cfg)
    ctl = ref_sweep.sweep(cols, cfg, torch.float32)
    d = check.reference_digest(ctl, len(cfg["schemes"]))
    n_bad, gap = check.compare(d, ref)
    assert not check.verdict({"bytes_unconserved": 0, "int_mismatches": n_bad,
                              "clock_rel_gap": gap}, cfg["limits"])
    assert gap > 10 * cfg["limits"]["clock_rel_gap"]


def test_capacity_rule_matches_the_config_totals():
    for name in CONFIGS:
        cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text())
        assert ref_sweep.capacity(cfg["totals"]["logical_bytes"], cfg) == \
            cfg["totals"]["ssd_bytes_per_node"]
