"""The port's bench-trajectory module (``repro_torch.testing.perf``)
against the reference's: the cases of ``tests/test_bench_trajectory.py``
that test the module itself, run on the port's copy, and the two copies
side by side (equal payloads, byte-identical files, the same reading of
the committed ``experiments/BENCH_8.json``).

The reference file's three ``TestRunCheckExit`` cases drive
``benchmarks/run.py``'s ``--check`` end to end; the port has no bench
runner (``benchmarks/`` is not ported), so they stay reference-only."""

import json
import os
import pathlib
import sys

import pytest

from repro.testing import perf as ref_perf
from repro_torch.testing import perf
from repro_torch.testing.perf import (
    atomic_write_text,
    build_trajectory,
    check_trajectory,
    emit_trajectory,
    find_anchor,
    merge_csv,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmarks.common import Row  # noqa: E402


class TestBuildTrajectory:
    ROWS = {"fleet": {"fleet_a": 100.0, "fleet_b": 300.0},
            "replay": {"replay_x": 50.0}}

    def test_schema_and_suite_fields(self):
        t = build_trajectory(self.ROWS, index=6)
        assert t["schema"] == "bench-trajectory/v1"
        assert t["index"] == 6
        assert t["anchor"] is None
        assert t["regression_threshold"] == pytest.approx(0.15)
        fleet = t["suites"]["fleet"]
        assert fleet["us_per_call"] == pytest.approx(400.0)
        assert fleet["rows"] == self.ROWS["fleet"]
        assert fleet["speedup_vs_anchor"] is None
        assert fleet["regression"] is False
        assert t["any_regression"] is False

    def _anchor(self, scale):
        return build_trajectory(
            {s: {k: v * scale for k, v in rows.items()}
             for s, rows in self.ROWS.items()})

    def test_speedup_vs_anchor(self):
        # anchor was 2x slower -> speedup 2.0, no regression
        t = build_trajectory(self.ROWS, anchor_payload=self._anchor(2.0),
                             anchor_name="BENCH_5.json")
        assert t["anchor"] == "BENCH_5.json"
        assert t["suites"]["fleet"]["speedup_vs_anchor"] == pytest.approx(2.0)
        assert not t["any_regression"]

    def test_regression_flag_at_threshold(self):
        # anchor 25% faster -> speedup 0.8 < 0.85 -> regression
        t = build_trajectory(self.ROWS, anchor_payload=self._anchor(0.8))
        assert t["suites"]["fleet"]["speedup_vs_anchor"] == pytest.approx(0.8)
        assert t["suites"]["fleet"]["regression"] is True
        assert t["any_regression"] is True
        assert check_trajectory(t) != []

    def test_within_threshold_not_flagged(self):
        # 10% slowdown stays inside the +/-15% band
        t = build_trajectory(self.ROWS, anchor_payload=self._anchor(0.9))
        assert t["suites"]["fleet"]["regression"] is False
        assert check_trajectory(t) == []

    def test_only_matched_rows_compared(self):
        anchor = build_trajectory(
            {"fleet": {"fleet_a": 10.0, "fleet_gone": 1.0}})
        t = build_trajectory({"fleet": {"fleet_a": 100.0,
                                        "fleet_new": 9999.0}},
                             anchor_payload=anchor)
        fleet = t["suites"]["fleet"]
        assert fleet["matched_rows"] == 1
        assert fleet["speedup_vs_anchor"] == pytest.approx(0.1)

    def test_suite_absent_from_anchor(self):
        anchor = build_trajectory({"fleet": {"fleet_a": 10.0}})
        t = build_trajectory({"replay": {"replay_x": 1.0}},
                             anchor_payload=anchor)
        assert t["suites"]["replay"]["speedup_vs_anchor"] is None


class TestAnchorsAndEmission:
    def test_find_anchor_picks_highest_below_index(self, tmp_path):
        for k in (2, 4, 9):
            (tmp_path / f"BENCH_{k}.json").write_text("{}")
        assert find_anchor(tmp_path, 6)[0] == 4
        assert find_anchor(tmp_path, 10)[0] == 9
        assert find_anchor(tmp_path, 2) is None

    def test_emit_injected_regression_roundtrip(self, tmp_path):
        """A synthetic 2x-faster anchor must trip the gate on emit."""

        anchor = build_trajectory({"fleet": {"fleet_a": 50.0}}, index=5)
        (tmp_path / "BENCH_5.json").write_text(json.dumps(anchor))
        path, payload = emit_trajectory({"fleet": {"fleet_a": 100.0}},
                                        directory=tmp_path, index=6)
        assert path.name == "BENCH_6.json"
        assert payload["anchor"] == "BENCH_5.json"
        assert payload["any_regression"] is True
        assert "fleet" in check_trajectory(payload)[0]
        on_disk = json.loads(path.read_text())
        assert on_disk == payload

    def test_partial_emit_merges_existing_suites(self, tmp_path):
        emit_trajectory({"fleet": {"a": 1.0}, "replay": {"b": 2.0}},
                        directory=tmp_path, index=6)
        _, payload = emit_trajectory({"fleet": {"a": 3.0}},
                                     directory=tmp_path, index=6)
        assert set(payload["suites"]) == {"fleet", "replay"}
        assert payload["suites"]["fleet"]["rows"] == {"a": 3.0}
        assert payload["suites"]["replay"]["rows"] == {"b": 2.0}


class TestAtomicWrites:
    def test_atomic_write_replaces_and_cleans_up(self, tmp_path):
        target = tmp_path / "out.csv"
        target.write_text("old\n")
        atomic_write_text(target, "new\n")
        assert target.read_text() == "new\n"
        assert [p.name for p in tmp_path.iterdir()] == ["out.csv"]

    def test_interrupted_build_leaves_previous_file(self, tmp_path):
        """The text is fully built before the write: a row that raises
        mid-iteration can never truncate the committed CSV."""

        target = tmp_path / "bench_results.csv"
        atomic_write_text(target, merge_csv(None, [Row("a", 1.0, "x=1")]))
        before = target.read_text()

        class Exploding:
            name = "boom"

            def csv(self):
                raise RuntimeError("interrupted")

        with pytest.raises(RuntimeError):
            atomic_write_text(target, merge_csv(before, [Exploding()]))
        assert target.read_text() == before
        assert [p.name for p in tmp_path.iterdir()] == [target.name]

    def test_merge_csv_preserves_unrun_suites(self):
        existing = ("name,us_per_call,derived\n"
                    "fleet_a,1.000,x=1\n"
                    "replay_b,2.000,y=2\n")
        merged = merge_csv(existing, [Row("fleet_a", 9.0, "x=9"),
                                      Row("new_c", 3.0, "z=3")])
        lines = merged.strip().splitlines()
        assert lines[0] == "name,us_per_call,derived"
        assert lines[1] == "fleet_a,9.000,x=9"      # replaced in place
        assert lines[2] == "replay_b,2.000,y=2"     # preserved
        assert lines[3] == "new_c,3.000,z=3"        # appended

    def test_merge_csv_from_scratch(self):
        merged = merge_csv(None, [Row("a", 1.0, "d=1")])
        assert merged == "name,us_per_call,derived\na,1.000,d=1\n"


def test_current_index_matches_committed_artifact():
    """experiments/BENCH_<CURRENT_INDEX>.json is the committed artifact."""

    path = os.path.join(REPO, "experiments", perf.bench_filename(perf.CURRENT_INDEX))
    assert os.path.exists(path), path
    with open(path) as f:
        payload = json.load(f)
    assert payload["schema"] == "bench-trajectory/v1"
    assert payload["index"] == perf.CURRENT_INDEX
    for suite in payload["suites"].values():
        assert suite["us_per_call"] > 0
        assert "speedup_vs_anchor" in suite
        assert "regression" in suite


# -- the port's copy against the reference's ----------------------------


def test_constants_equal_the_reference():
    assert (perf.SCHEMA, perf.CURRENT_INDEX, perf.REGRESSION_THRESHOLD) == \
        (ref_perf.SCHEMA, ref_perf.CURRENT_INDEX, ref_perf.REGRESSION_THRESHOLD)
    assert perf.bench_filename(7) == ref_perf.bench_filename(7)


ROW_SETS = {
    "no_anchor": ({"fleet": {"fleet_a": 100.0, "fleet_b": 300.0},
                   "replay": {"replay_x": 50.0}}, None),
    "regressed": ({"fleet": {"fleet_a": 100.0, "fleet_new": 7.5}},
                  {"fleet": {"fleet_a": 10.0, "fleet_gone": 1.0}}),
    "faster": ({"fleet": {"fleet_a": 1.0}, "replay": {"r": 2.0}},
               {"fleet": {"fleet_a": 3.0}}),
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_build_trajectory_equals_the_reference(name):
    rows, anchor_rows = ROW_SETS[name]
    anchor = None if anchor_rows is None else ref_perf.build_trajectory(anchor_rows, index=5)
    args = dict(index=6, anchor_payload=anchor, anchor_name=anchor and "BENCH_5.json")
    assert perf.build_trajectory(rows, **args) == ref_perf.build_trajectory(rows, **args)


def test_emit_writes_byte_identical_files(tmp_path):
    """The same anchor and the same two emissions (the second partial) in
    two directories: the files are the same bytes."""

    anchor = json.dumps(ref_perf.build_trajectory({"fleet": {"fleet_a": 50.0}}, index=5))
    written = []
    for mod, sub in ((perf, "port"), (ref_perf, "reference")):
        d = tmp_path / sub
        d.mkdir()
        (d / "BENCH_5.json").write_text(anchor)
        mod.emit_trajectory({"fleet": {"fleet_a": 100.0}, "replay": {"b": 2.0}},
                            directory=d, index=6)
        path, _ = mod.emit_trajectory({"fleet": {"fleet_a": 40.0}}, directory=d, index=6)
        written.append(path.read_bytes())
    assert written[0] == written[1]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["BENCH_5.json", "BENCH_6.json"]


def test_committed_artifact_reads_the_same():
    with open(REPO / "experiments" / ref_perf.bench_filename(ref_perf.CURRENT_INDEX)) as f:
        payload = json.load(f)
    assert perf.check_trajectory(payload) == ref_perf.check_trajectory(payload)
    assert perf.format_trajectory(payload) == ref_perf.format_trajectory(payload)
    assert perf.format_trajectory(payload).count("\n") == len(payload["suites"])
