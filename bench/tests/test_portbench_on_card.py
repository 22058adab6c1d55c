"""Every cell on the CUDA card, briefly, through ``bench/run.py`` itself:
a correct result with the cell's end-to-end metrics, and, traced, every
per-layer metric the cell lists.  Skips without a card (run on the H100
with ``python -m pytest -m cuda bench/tests``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench_util import REPO

from bench.harness import registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(card, workload, trace):
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", workload,
                        "--seed", str(2**31 + 401), "--seconds", "3", "--trace", str(trace)],
                       capture_output=True, text=True, cwd=str(REPO), timeout=360,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    cell = registry.cell(workload)
    want = [m["name"] for m in cell.end_to_end] if not trace else list(cell.metrics)
    assert sorted(res["metrics"]) == sorted(want)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
        assert all(0 < v["value"] <= 100 for k, v in res["metrics"].items()
                   if v["unit"] == "%")
