"""The port stands alone: no module of it imports JAX or the reference
package, it runs (fleet sweep, the online service, the checkpoint store and
serving) with both blocked, and its entry points refuse to fall back to the
CPU quietly when no CUDA card is present."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (FleetProgram, FleetSimulator, IONodeSimulator,
                              compute_stream_scores, replay_lanes, run_fleet_schemes,
                              run_schemes, simulate_device)
from repro_torch.core import engine_device as ed
from repro_torch.launch.serve import serve
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.service import BurstBufferService, run_service_schemes
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


def test_scan_covers_the_host_engine_modules():
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    for mod in ("avl", "extent_index", "log_store", "pipeline", "redirector", "ftl",
                "simulator", "fleet", "device_model", "burst_buffer"):
        assert f"core/{mod}.py" in names
    for mod in ("__init__", "arrivals", "injector", "loop", "metrics"):
        assert f"service/{mod}.py" in names
    assert {"checkpoint/__init__.py", "checkpoint/tiered_store.py",
            "distributed/fault_tolerance.py", "testing/golden.py",
            "testing/service.py"} <= names


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
from repro_torch.core import run_fleet_schemes, run_schemes
ftl = FleetProgram(num_nodes=2, ssd_capacity=4 << 20, ssd="ftl", stream_len=96,
                   device="cpu").run(batch)
host = run_fleet_schemes(batch, num_nodes=2, ssd="ftl", ssd_capacity=4 << 20, device="cpu")
one = run_schemes(batch, engine="per-request", device="cpu")
assert all(fr.total_bytes == batch.total_bytes for fr in (*ftl.values(), *host.values()))
assert all(r.total_bytes == batch.total_bytes for r in one.values())
import repro_torch.testing.golden
import repro_torch.distributed.fault_tolerance
from repro_torch.service import BurstBufferService, poisson_arrivals, scripted
svc = BurstBufferService(num_nodes=4, ssd_capacity=16 << 20, epoch_seconds=0.5,
                         heartbeat_timeout=2.0, injector=scripted((1.0, "crash", 1)),
                         device="cpu").run(poisson_arrivals(batch, rate_rps=500.0, seed=1))
assert svc.metrics.conservation_violations() == [] and svc.metrics.faults
import tempfile
import numpy as np
from repro_torch.checkpoint import TieredCheckpointStore
with tempfile.TemporaryDirectory() as root:
    store = TieredCheckpointStore(root)
    store.save(1, {"w": np.arange(1000, dtype=np.float32)})
    assert (store.load(1)["w"] == np.arange(1000, dtype=np.float32)).all()
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
for arch in ("qwen3-1.7b", "stablelm-3b", "zamba2-2.7b", "falcon-mamba-7b"):
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
    with pytest.raises(RuntimeError, match="CUDA"):
        IONodeSimulator(score_backend="numpy").run(batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_schemes(batch, engine="per-request")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetSimulator(score_backend="numpy").run(batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet_schemes(batch, score_backend="numpy")
    assert IONodeSimulator(device="cpu").run(batch).total_bytes == batch.total_bytes
    assert run_schemes(batch, device="cpu")["ssdup+"].total_bytes == batch.total_bytes
    assert FleetSimulator(device="cpu").run(batch).total_bytes == batch.total_bytes
    assert run_fleet_schemes(batch, device="cpu")["orangefs"].total_bytes == batch.total_bytes
    with pytest.raises(RuntimeError, match="CUDA"):
        BurstBufferService()
    with pytest.raises(RuntimeError, match="CUDA"):
        BurstBufferService(score_backend="numpy")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_service_schemes(batch)
    assert BurstBufferService(device="cpu").run(batch).metrics.completed_bytes == \
        batch.total_bytes
    assert run_service_schemes(batch, device="cpu")["ssdup"].fleet.total_bytes == \
        batch.total_bytes


def test_model_entry_points_need_cuda_by_default(no_cuda):
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, batch=1, prompt_len=4, gen=1)
    assert get_model(cfg, device="cpu").device.type == "cpu"


def _reference_shaped_tree(params) -> dict:
    """A parameter tree in the reference's form (NumPy leaves, per-layer
    leaves stacked on L), made from the port's own parameters."""

    tree: dict = {"layers": {}}
    for name, t in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"].setdefault(parts[-1], {})[int(parts[1])] = t.detach().numpy()
        else:
            tree[parts[-1]] = t.detach().numpy()
    tree["layers"] = {k: np.stack([v[i] for i in sorted(v)]) for k, v in tree["layers"].items()}
    return tree


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_params_from_jax_needs_cuda_by_default(no_cuda, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")  # NumPy has no bf16
    params = get_model(cfg, device="cpu").init_params(0)
    tree = _reference_shaped_tree(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, tree)
    back = params_from_jax(cfg, tree, device="cpu")
    for (name, a), (_, b) in zip(params.named_parameters(), back.named_parameters()):
        assert b.device.type == "cpu" and torch.equal(a, b), name


def test_scan_covers_the_model_modules():
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    assert {"models/hybrid.py", "models/mamba.py", "models/transformer.py",
            "models/layers.py", "models/params.py", "models/convert.py",
            "configs/zamba2_2p7b.py", "configs/stablelm_3b.py", "configs/phi4_mini_3p8b.py",
            "configs/starcoder2_3b.py"} <= names


def test_scan_covers_the_training_modules():
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    assert {"optim/__init__.py", "optim/adamw.py", "optim/schedules.py",
            "optim/compression.py", "data/__init__.py", "data/pipeline.py",
            "checkpoint/checkpointer.py", "launch/steps.py", "launch/train.py"} <= names


_BLOCKED_TRAIN = r'''
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import tempfile
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as root:
    args = ["--device", "cpu", "--arch", "qwen3-1.7b", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", root, "--ckpt-every", "2"]
    train.main(args)
    train.main(args[:5] + ["4"] + args[6:] + ["--resume"])
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
'''


def test_training_runs_with_jax_and_reference_blocked():
    """The smoke config trains in bf16, checkpoints and resumes with JAX,
    the reference and ``ml_dtypes`` all blocked."""

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "resumed from step 3" in proc.stdout and proc.stdout.rstrip().endswith("ok")


def test_training_entry_points_need_cuda_by_default(no_cuda, tmp_path):
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "falcon-mamba-7b", "--steps", "1"])
    train.main(["--device", "cpu", "--steps", "1", "--batch", "1", "--seq", "8"])


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run exits nonzero and prints no result."""

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
