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
# the port's user entry points: the examples and the anomaly hunt
ENTRY_FILES = sorted((REPO / "examples_torch").glob("*.py")) + [
    REPO / "experiments" / "anomaly_hunt_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_memory_probe.py",
                                              REPO / "chip_stream_variants.py",
                                              REPO / "chip_replay_compare.py"] + ENTRY_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
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
            "testing/service.py", "testing/perf.py", "analysis/engine.py",
            "analysis/rules.py", "analysis/cli.py", "analysis/baseline.py",
            "analysis/__main__.py"} <= names
    assert {p.stem for p in ENTRY_FILES} == {
        "quickstart", "fleet_sim", "batched_replay", "service_failover", "elastic_recovery",
        "serve_batched", "train_checkpointed", "anomaly_hunt_torch"}


def test_every_reference_module_and_example_has_a_counterpart():
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}

    assert modules(REPO / "src" / "repro") - modules(REPO / "src" / "repro_torch") == set()
    assert {p.name for p in (REPO / "examples").glob("*.py")} == \
        {p.name for p in (REPO / "examples_torch").glob("*.py")}


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
from repro_torch.analysis import check_paths, sanitizing
with sanitizing():
    checked = FleetProgram(num_nodes=2, policy="round-robin-app", ssd_capacity=64 << 20,
                           device="cpu").run(batch)
assert checked == res
import contextlib, io, pathlib, runpy
import repro_torch
assert check_paths([pathlib.Path(repro_torch.__file__).parent]) == []
sys.argv, listing = ["python -m repro_torch.analysis", "--list-rules"], io.StringIO()
with contextlib.redirect_stdout(listing), contextlib.suppress(SystemExit):
    runpy.run_module("repro_torch.analysis", run_name="__main__", alter_sys=True)
assert [l.split()[0] for l in listing.getvalue().splitlines() if l.startswith("SL")] == \
    ["SL101", "SL104", "SL105", "SL106", "SL107", "SL108", "SL109", "SL110", "SL111"]
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
for arch in ("qwen3-1.7b", "stablelm-3b", "zamba2-2.7b", "falcon-mamba-7b",
             "moonshot-v1-16b-a3b", "grok-1-314b", "internvl2-26b", "whisper-tiny"):
    out = serve(get_smoke_config(arch), batch=2, prompt_len=8, gen=3, device="cpu")
    assert out["tokens"].shape == (2, 3)
from repro_torch.distributed.sharding import spec_for
from repro_torch.launch import dryrun, hillclimb, mesh, roofline
class Mesh: shape = {"data": 16, "model": 16}
assert spec_for((28, 2048, 6144), ("layers", "embed", "mlp"), Mesh()) == (None, "data", "model")
rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", "single", tempfile.mkdtemp(),
                      override_cfg=get_smoke_config("qwen3-1.7b"), device="cpu")
assert rec["status"] == "ok" and rec["collectives"]["counts"]
assert roofline.collectives_from_records([("all-reduce", 40, 4)]).link_bytes == 60.0
examples = pathlib.Path(repro_torch.__file__).parents[2] / "examples_torch"
for name in ("quickstart", "elastic_recovery"):
    sys.argv = [name] + (["--device", "cpu"] if name == "quickstart" else [])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(str(examples / f"{name}.py"), run_name="__main__")
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
    for arch in ("qwen3-1.7b", "moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny"):
        cfg = get_smoke_config(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve(cfg, batch=1, prompt_len=4, gen=1)
        assert get_model(cfg, device="cpu").device.type == "cpu"


def _reference_shaped_tree(params) -> dict:
    """A parameter tree in the reference's form (NumPy leaves, per-layer
    leaves stacked on L under ``"layers"``, or under ``"encoder"`` and
    ``"decoder"``), made from the port's own parameters."""

    tree: dict = {}
    for name, t in params.named_parameters():
        parts = name.split(".")
        if len(parts) == 3:
            tree.setdefault(parts[0], {}).setdefault(parts[-1], {})[int(parts[1])] = \
                t.detach().numpy()
        else:
            tree[parts[-1]] = t.detach().numpy()
    for stack in ("layers", "encoder", "decoder"):
        if stack in tree:
            tree[stack] = {k: np.stack([v[i] for i in sorted(v)])
                           for k, v in tree[stack].items()}
    return tree


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b", "moonshot-v1-16b-a3b",
                                  "whisper-tiny"])
def test_params_from_jax_needs_cuda_by_default(no_cuda, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")  # NumPy has no bf16
    params = get_model(cfg, device="cpu").init_params(0)
    tree = _reference_shaped_tree(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, tree)
    back = params_from_jax(cfg, tree, device="cpu")
    for (name, a), (_, b) in zip(params.named_parameters(), back.named_parameters()):
        assert b.device.type == "cpu" and torch.equal(a, b), name


_BLOCKED_MESH = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import dataclasses, tempfile
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.models import frontend_inputs, get_model
from repro_torch.models.convert import tree_from_params
from repro_torch.testing.sharded import sharded_steps
for arch, cell in (("falcon-mamba-7b", "long_500k"), ("zamba2-2.7b", "long_500k"),
                   ("whisper-tiny", "decode_32k")):
    rec = dryrun.run_cell(arch, cell, "single", tempfile.mkdtemp(),
                          override_cfg=get_smoke_config(arch), device="cpu")
    assert rec["status"] == "ok" and rec["collectives"]["counts"], (arch, cell)
assert "falcon_train" in hillclimb.TARGETS
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
for arch, lever in (("falcon-mamba-7b", {}), ("falcon-mamba-7b", {"mamba_fused_proj": True}),
                    ("zamba2-2.7b", {}), ("whisper-tiny", {}), ("qwen3-1.7b", {"embed_onehot": True})):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **lever)
    tree = tree_from_params(get_model(cfg, "cpu").init_params(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **frontend_inputs(cfg, 2, 2, "cpu")}
    kw = dict(decode_steps=2, serve_first=True)
    plain = sharded_steps(cfg, tree, batch, None, **kw)
    out = sharded_steps(cfg, tree, batch, mesh, decode_tokens=plain["decode_tokens"], **kw)
    assert torch.equal(out["decode_tokens"], plain["decode_tokens"]), arch
    assert torch.allclose(out["loss"], plain["loss"], rtol=1e-5), arch
    for got, want in zip([out["prefill_logits"], *out["decode_logits"]],
                         [plain["prefill_logits"], *plain["decode_logits"]], strict=True):
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), arch
dist.destroy_process_group()
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""


def test_sharded_families_run_with_jax_and_reference_blocked():
    """The ssm, hybrid and encoder-decoder families' dry runs and sharded
    steps (and the one-hot embedding's) run on a one-rank ``gloo`` mesh
    with JAX and the reference blocked, served before the train step and
    fed the plain run's decode tokens, as ``chip_smoke.py`` runs them,
    equal to the plain steps."""

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_MESH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.rstrip().endswith("ok")


def test_scan_covers_the_model_modules():
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    assert {"models/hybrid.py", "models/mamba.py", "models/transformer.py",
            "models/encdec.py", "models/layers.py", "models/params.py", "models/convert.py",
            "configs/zamba2_2p7b.py", "configs/stablelm_3b.py", "configs/phi4_mini_3p8b.py",
            "configs/starcoder2_3b.py", "configs/moonshot_v1_16b_a3b.py",
            "configs/grok_1_314b.py", "configs/internvl2_26b.py",
            "configs/whisper_tiny.py"} <= names


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


def test_scan_covers_the_mesh_modules():
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    assert {"distributed/sharding.py", "launch/mesh.py", "launch/roofline.py",
            "launch/dryrun.py", "launch/hillclimb.py", "testing/sharded.py",
            "models/registry.py", "optim/adamw.py", "checkpoint/checkpointer.py"} <= names


def test_only_the_mesh_module_imports_torch_testing_internal():
    """The fake process group lives under ``torch.testing._internal``: one
    import of it, so a torch upgrade that moves it breaks one line."""

    importers = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.startswith("torch.testing._internal") for n in names):
                importers.append(path.relative_to(REPO).as_posix())
    assert importers == ["src/repro_torch/launch/mesh.py"]


def test_dry_run_and_meshes_need_cuda_by_default(no_cuda, tmp_path):
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen3-1.7b", "--cell", "train_4k", "--mesh", "single",
                     "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("qwen3-1.7b", "train_4k", "single", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        hillclimb.main(["--target", "qwen3_train"])
    assert not list(tmp_path.iterdir())


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run exits nonzero and prints no result."""

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_replay_compare_refuses_without_cuda():
    """Without a card the replay timing exits nonzero and prints no turn."""

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_replay_compare.py")], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == ""


def test_chip_memory_probe_refuses_without_cuda():
    """Without a card the memory probe exits nonzero and prints no reading."""

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_memory_probe.py")], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == ""
