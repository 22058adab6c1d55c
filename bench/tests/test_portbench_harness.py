"""The harness on the CPU, at small shapes, with its look for a card
skipped: it finds a cell's parts by name, a new configuration, traffic
mix and per-layer metric join as new files alone, a metric whose wrapped
function is gone is reported missing (never 0), and a run whose timed
path is broken underneath comes out not correct."""

import json
import sys

import numpy as np
import pytest
import torch

from portbench_util import run, small_bench

from bench.harness import registry
from bench.reference import sweep as ref_sweep
from repro_torch.core import engine_device as ed
from repro_torch.core import fleet
from repro_torch.core.simulator import SimResult
from repro_torch.core.trace import TraceBatch
from repro_torch.kernels.replay import ops as replay_ops

CELLS = ("ior-segrandom-2n.fresh", "ior-segrandom-2n.resweep", "ior-segcontig-2n.fresh")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(root, workload):
    rc, res, err = run(root, workload)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "sweep_rate", "peak_mib"}
    assert all(v["value"] > 0 for k, v in res["metrics"].items() if k != "peak_mib")
    assert list(res)[-1] == "checks"
    limits = registry.cell(workload, root).config["limits"]
    assert res["checks"] == {k: {"value": 0, "limit": limits[k]} for k in limits}
    assert err.strip().splitlines()[-1].startswith("check clock_rel_gap:")


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_the_host_layers(root, workload):
    rc, res, err = run(root, workload, trace=True)
    assert rc == 0, err
    m = res["metrics"]
    assert {"fleet_self_ms", "stack_ms"} <= set(m)
    assert ("tapes_ms" in m) == workload.endswith(".fresh")
    assert all(v["value"] > 0 for v in m.values())
    # no card: the device's metrics have nothing to read, and are left out
    assert "replay_kernel_ms" not in m and "device_idle_pct" not in m
    assert "metric replay_kernel_ms: nothing to read" in err


def test_the_layers_partition_a_fresh_sweep(root):
    rc, res, _ = run(root, "ior-segrandom-2n.fresh", trace=True, seconds=0.5)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    parts = sum(m[k] for k in ("fleet_self_ms", "shard_ms", "score_ms", "tapes_ms",
                               "stack_ms"))
    assert parts > 0.5 * m["tapes_ms"]
    assert m["tapes_ms"] > m["shard_ms"] and m["tapes_ms"] > m["score_ms"]


def test_a_new_cell_joins_as_new_files(root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    of their own, and entries in BENCHMARK.json, form a cell; no existing
    file of the harness is edited."""

    import shutil

    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    before = {p: p.read_bytes() for p in (new / "bench").rglob("*") if p.is_file()}
    cfg = json.loads((new / "bench" / "configs" / "ior-segrandom-2n.json").read_text())
    cfg.update(name="ior-segrandom-8n", nodes=8)
    (new / "bench" / "configs" / "ior-segrandom-8n.json").write_text(json.dumps(cfg))
    (new / "bench" / "traffic" / "twice.json").write_text(json.dumps(
        {"new_trace_every_sweep": True, "warm_sweeps": 2, "checked_traces": 1}))
    (new / "bench" / "metrics" / "tapes_calls.py").write_text(
        'UNIT = "1"\n'
        'WRAPS = ("repro_torch.core.engine_device:build_events",)\n'
        'def read(w):\n'
        '    n = sum(s.key == WRAPS[0] for s in w.rec.spans)\n'
        '    return n / w.sweeps if n else None\n')
    (new / "bench" / "metrics" / "gone_ms.py").write_text(
        'UNIT = "ms"\n'
        'WRAPS = ("repro_torch.core.engine_device:no_such_function",)\n'
        'def read(w):\n'
        '    return w.per_sweep_ms(w.total_s(*WRAPS))\n')
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ior-segrandom-8n", "source": "https://github.com/hpc/ior",
                             "file": "bench/configs/ior-segrandom-8n.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "ior-segrandom-8n.twice", "config": "ior-segrandom-8n",
                               "traffic": "twice", "chips": 1, "why": "a test"})
    for name, unit in (("tapes_calls", "1"), ("gone_ms", "ms")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": "program_span", "layer": "tapes",
                                   "moves": "sweep_rate",
                                   "workloads": ["ior-segrandom-8n.twice"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("ior-segrandom-8n.twice", new)
    assert cell.config["nodes"] == 8 and cell.mix["warm_sweeps"] == 2
    assert set(cell.metrics) == {"tapes_calls", "gone_ms"}
    rc, res, err = run(new, "ior-segrandom-8n.twice", trace=True)
    assert rc == 0, err
    assert res["correct"]
    assert res["metrics"]["tapes_calls"]["value"] == 8
    assert "gone_ms" not in res["metrics"]
    assert "metric gone_ms: missing" in err and "no_such_function" in err
    # the older cells are untouched and still run
    assert "tapes_calls" not in registry.cell("ior-segrandom-2n.fresh", new).metrics
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_cell_installs_only_its_own_metrics_probes(root, tmp_path, monkeypatch):
    """A metric added for a new cell, wrapping a call inside the fleet's
    sweep, is not installed in the older cells' traced runs, so their
    spans and self times stay as they were."""

    import shutil

    from bench.harness import cell as cell_mod

    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    lane_key = "repro_torch.core.engine_device:lane_result"
    (new / "bench" / "metrics" / "lane_ms.py").write_text(
        f'UNIT = "ms"\nWRAPS = ("{lane_key}",)\n'
        'def read(w):\n'
        '    return w.per_sweep_ms(w.total_s(*WRAPS))\n')
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "lane_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "fleet",
                               "moves": "sweep_rate",
                               "workloads": ["ior-segrandom-2n.fresh"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    installed = {}
    orig = cell_mod.install

    def spy(rec, keys):
        installed.setdefault("keys", []).append(list(keys))
        return orig(rec, keys)

    monkeypatch.setattr(cell_mod, "install", spy)
    rc, res, err = run(new, "ior-segrandom-2n.resweep", trace=True)
    assert rc == 0, err
    assert lane_key not in installed["keys"][-1]
    assert "lane_ms" not in res["metrics"]
    rc, res, err = run(new, "ior-segrandom-2n.fresh", trace=True)
    assert rc == 0, err
    assert lane_key in installed["keys"][-1]
    assert res["metrics"]["lane_ms"]["value"] > 0


def test_self_time_subtracts_only_the_children_it_names():
    """A self time subtracts the spans its metric names, through any other
    span between them, and nothing else."""

    from bench.harness.probes import Recorder, Span
    from bench.harness.readings import Window

    rec = Recorder(lambda: None)
    rec.spans = [Span("run", 0.0, 10.0, -1),      # 0
                 Span("other", 1.0, 6.0, 0),      # 1: another metric's span
                 Span("child", 2.0, 5.0, 1),      # 2: named, under "other"
                 Span("child", 3.0, 4.0, 2),      # 3: nested in a named one
                 Span("child", 7.0, 8.0, 0),      # 4
                 Span("run", 20.0, 21.0, -1)]     # 5
    w = Window(rec, [10.0, 1.0], None, None, 11.0)
    assert w.self_s("run", ("child",)) == pytest.approx(10.0 - 3.0 - 1.0 + 1.0)
    assert w.self_s("run", ()) == pytest.approx(11.0)
    assert w.self_s("gone", ("child",)) is None


# -- the timed path broken underneath: the check must say "not correct" ----

def _nudge_lane(monkeypatch):
    orig = ed.lane_result

    def nudged(out, i, scheme, per_app):
        r = orig(out, i, scheme, per_app)
        if i == 5:
            import dataclasses
            r = dataclasses.replace(r, bytes_to_ssd=r.bytes_to_ssd + 1,
                                    total_bytes=r.total_bytes + 1)
        return r

    monkeypatch.setattr(ed, "lane_result", nudged)


def _drop_half(monkeypatch):
    orig = TraceBatch.shard

    def half(self, assignment, num_nodes):
        shards = orig(self, assignment, num_nodes)
        return [s.select(np.arange(s.num_requests // 2)) if n == 0 else s
                for n, s in enumerate(shards)]

    monkeypatch.setattr(TraceBatch, "shard", half)


def _state_unchanged(monkeypatch):
    orig = replay_ops.replay_op
    monkeypatch.setattr(replay_ops, "replay_op", lambda p, g, steps: orig(p, g, 0))


def _float32_in_place(monkeypatch):
    """The control: the reference in float32 put in the program's place."""

    def run32(self, trace):
        cols = {k: getattr(trace, k) for k in ("offsets", "sizes", "file_ids", "app_ids",
                                              "gap_positions", "gap_seconds")}
        cfg = {"ssd": "constant", "nodes": self.num_nodes, "schemes": self.schemes,
               "stream_len": self.stream_len, "policy": self.policy,
               "ssd_capacity": {"share_num": 1, "share_den": 2,
                                "floor_bytes": self.ssd_capacity},
               "adaptive_window": self.adaptive_window, "flush_gate": self.flush_gate}
        out = ref_sweep.sweep(cols, cfg, torch.float32)
        res = {}
        for si, s in enumerate(self.schemes):
            nodes = tuple(SimResult(
                scheme=s, io_seconds=float(out["io_seconds"][si, n]),
                total_seconds=float(out["total_seconds"][si, n]),
                total_bytes=int(out["bytes_to_ssd"][si, n] + out["bytes_to_hdd_direct"][si, n]),
                bytes_to_ssd=int(out["bytes_to_ssd"][si, n]),
                bytes_to_hdd_direct=int(out["bytes_to_hdd_direct"][si, n]),
                flushes=int(out["flushes"][si, n]),
                flush_paused_seconds=float(out["flush_paused_seconds"][si, n]),
                blocked_seconds=float(out["blocked_seconds"][si, n]),
                peak_ssd_occupancy=int(out["peak_ssd_occupancy"][si, n]),
                metadata_bytes=0, per_app_bytes=out["per_app"][n])
                for n in range(self.num_nodes))
            res[s] = fleet.FleetResult(scheme=s, policy=self.policy,
                                       num_nodes=self.num_nodes, node_results=nodes)
        return res

    monkeypatch.setattr(fleet.FleetProgram, "run", run32)


FAULTS = {"answer_altered": (_nudge_lane, "int_mismatches"),
          "half_the_batch_left_out": (_drop_half, "bytes_unconserved"),
          "state_returned_unchanged": (_state_unchanged, "int_mismatches"),
          "float32_control": (_float32_in_place, "clock_rel_gap")}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, workload, fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    rc, res, err = run(root, workload, seed=2**31 + 99)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["failed"] >= 1
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_jax_loaded_during_the_run_refuses_the_result(root, monkeypatch):
    from bench.harness.cell import FORBIDDEN

    for name in [n for n in sys.modules if n.partition(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)  # held by other test files
    orig = fleet.FleetProgram.run

    def loads_jax(self, trace):
        monkeypatch.setitem(sys.modules, "jaxlib", type(sys)("jaxlib"))
        return orig(self, trace)

    monkeypatch.setattr(fleet.FleetProgram, "run", loads_jax)
    rc, res, err = run(root, "ior-segrandom-2n.resweep")
    assert rc != 0 and res is None
    assert "loaded in the benchmark's process: jaxlib" in err
