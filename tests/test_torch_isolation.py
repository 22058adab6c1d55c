"""The port stands alone: no module of it imports JAX or the reference
package, it runs (fleet sweep and serving) with both blocked, and its entry
points refuse to fall back to the CPU quietly when no CUDA card is
present."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import FleetProgram, compute_stream_scores, replay_lanes, simulate_device
from repro_torch.core import engine_device as ed
from repro_torch.launch.serve import serve
from repro_torch.models import get_model
from repro_torch.testing.traces import golden_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


_BLOCKED_RUN = r'''
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
from repro_torch.core import FleetProgram
from repro_torch.testing.traces import golden_trace
batch = golden_trace("strided-gaps")
res = FleetProgram(num_nodes=2, policy="round-robin-app", ssd_capacity=64 << 20,
                   device="cpu").run(batch)
assert all(fr.total_bytes == batch.total_bytes for fr in res.values())
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
for arch in ("qwen3-1.7b", "falcon-mamba-7b"):
    out = serve(get_smoke_config(arch), batch=2, prompt_len=8, gen=3, device="cpu")
    assert out["tokens"].shape == (2, 3)
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok", sorted(res))
'''


def test_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fleet_program_needs_cuda_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetProgram()
    FleetProgram(device="cpu")


def test_other_entry_points_need_cuda_by_default(no_cuda):
    batch = golden_trace("strided-gaps")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_stream_scores(batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_device(batch)
    tape = ed.build_events(batch, compute_stream_scores(batch, backend="numpy"))
    args = (ed.stack_events([tape]),
            ed._stack_lanes([ed.lane_consts("ssdup+", 1 << 26)]),
            ed._stack_lanes([ed.initial_lane_state("ssdup+", 64)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_lanes(*args)


def test_model_entry_points_need_cuda_by_default(no_cuda):
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, batch=1, prompt_len=4, gen=1)
    assert get_model(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run exits nonzero and prints no result."""

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
