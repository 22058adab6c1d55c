"""The port's anomaly hunt (``experiments/anomaly_hunt_torch.py``) against
the reference's bisection tool (``experiments/anomaly_hunt.py``) on the
CPU: at its defaults it writes ``experiments/anomaly_hunt.csv`` byte for
byte and prints the reference's table, every fleet run scoring its shards
in one call of the stream kernel's wrapper; ``--straggler 16`` prints the
reference's decision table; and without ``--device cpu`` it wants a card.
The reference script is loaded by path and run unedited."""

import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
CSV = REPO / "experiments" / "anomaly_hunt.csv"


def load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"hunt_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stdout_of(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_hunt_at_its_defaults_writes_the_committed_csv(tmp_path, monkeypatch):
    import repro_torch.core.fleet as fleet

    calls = []
    real = fleet._score_shards_kernel
    monkeypatch.setattr(fleet, "_score_shards_kernel",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    rc, got = stdout_of(load(REPO / "experiments" / "anomaly_hunt_torch.py").main,
                        ["--device", "cpu", "--csv", str(tmp_path / "port.csv")])
    assert rc == 0
    assert (tmp_path / "port.csv").read_bytes() == CSV.read_bytes()
    rows = CSV.read_text().splitlines()[1:]
    assert len(calls) == len(rows) == 86  # one scoring call a fleet run
    rc, want = stdout_of(load(REPO / "experiments" / "anomaly_hunt.py").main,
                         ["--csv", str(tmp_path / "ref.csv")])
    assert rc == 0
    assert got.replace("port.csv", "ref.csv") == want


def test_straggler_drill_down_equals_the_reference():
    rc, got = stdout_of(load(REPO / "experiments" / "anomaly_hunt_torch.py").main,
                        ["--device", "cpu", "--straggler", "16"])
    assert rc == 0
    _, want = stdout_of(load(REPO / "experiments" / "anomaly_hunt.py").main,
                        ["--straggler", "16"])
    assert got == want
    assert "== straggler: node 7/16 (ssdup+, range-offset) ==" in got


def test_hunt_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        load(REPO / "experiments" / "anomaly_hunt_torch.py").main(["--straggler", "16"])


def test_hunt_runs_as_main(tmp_path):
    out = tmp_path / "hunt.csv"
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(REPO / "experiments" / "anomaly_hunt_torch.py"),
                           "--device", "cpu", "--skip", "flush-gate,threshold-scope,"
                           "adaptive-window,burstiness", "--csv", str(out)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    base = [r for r in CSV.read_text().splitlines() if r.startswith(("experiment,", "base,"))]
    assert out.read_text().splitlines() == base
