"""The port's ``Checkpointer`` and the store's bfloat16 leaves, against the
reference's checkpoint substrate.

A bfloat16 leaf is written as its bits with the manifest's ``dtype``
``"bfloat16"``, as the reference writes it, and read back without
``ml_dtypes`` (which ships with JAX, and which a machine that runs only the
port lacks).  Checkpoints of a model's parameters are in the reference's
layout, so either package loads the other's, bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import TieredCheckpointStore as JStore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import config_from_jax, params_from_jax, tree_from_params

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-1.7b", "falcon-mamba-7b"]


def bits(x) -> np.ndarray:
    """A leaf's bytes as integers (bf16 from either package, or f32)."""

    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def same_bits(a, b) -> None:
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(bits(x), bits(y))


_NO_ML_DTYPES = r'''
import sys
sys.modules["ml_dtypes"] = None
sys.modules["jax"] = None
import json, os, torch
from repro_torch.checkpoint import TieredCheckpointStore
root = sys.argv[1]
g = torch.Generator().manual_seed(0)
w = torch.randn(64, 33, generator=g).to(torch.bfloat16)
w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
tree = {"params": {"w": w, "b": torch.randn(7, generator=g)}, "step": torch.tensor(3)}
store = TieredCheckpointStore(root)
store.save(1, tree)
out = store.load(1)
assert out["params"]["w"].dtype == torch.bfloat16
assert torch.equal(out["params"]["w"].view(torch.int16), w.view(torch.int16))
assert (out["params"]["b"] == tree["params"]["b"].numpy()).all() and int(out["step"]) == 3
with open(store.manifest_path(1)) as f:
    man = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
assert man["params/w"]["dtype"] == "bfloat16" and man["params/w"]["shape"] == [64, 33]
assert man["params/w"]["nbytes"] == 64 * 33 * 2
assert "ml_dtypes" not in sys.modules or sys.modules["ml_dtypes"] is None
print("ok")
'''


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"


def test_store_leaf_types(tmp_path):
    """NumPy leaves load as NumPy (as before); bf16 leaves, from either
    package, load as ``torch.bfloat16``; torch leaves of other dtypes load
    as NumPy arrays of their dtype."""

    store = TieredCheckpointStore(str(tmp_path))
    tree = {"np": np.arange(6, dtype=np.int64).reshape(2, 3),
            "jax_bf16": np.asarray(jnp.linspace(-2, 2, 9, dtype=jnp.bfloat16)),
            "torch_bf16": torch.linspace(-3, 3, 5).to(torch.bfloat16),
            "torch_f16": torch.linspace(0, 1, 4).to(torch.float16)}
    store.save(4, tree)
    out = store.load(4)
    assert isinstance(out["np"], np.ndarray) and out["np"].dtype == np.int64
    assert out["torch_f16"].dtype == np.float16
    for key in ("jax_bf16", "torch_bf16"):
        assert out[key].dtype == torch.bfloat16
    same_bits(out, tree)


def reference_bf16_params(arch: str):
    jcfg = jax_smoke_config(arch)
    assert jcfg.dtype == "bfloat16"
    return jcfg, jax.tree.map(np.asarray, jax_get_model(jcfg).init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages_bit_for_bit(arch, tmp_path):
    jcfg, jtree = reference_bf16_params(arch)
    tcfg = config_from_jax(jcfg)
    params = params_from_jax(tcfg, jtree, device="cpu")

    # the reference writes, the port restores
    jck = JCheckpointer(JStore(str(tmp_path / "ref"), host_id=0))
    jck.save_blocking(5, {"params": jtree})
    jck.close()
    ck = Checkpointer(TieredCheckpointStore(str(tmp_path / "ref"), host_id=0))
    step, tree = ck.restore_latest(like={"params": tree_from_params(params)})
    ck.close()
    assert step == 5
    restored = params_from_jax(tcfg, tree["params"], device="cpu")
    for (name, a), b in zip(params.named_parameters(), restored.parameters()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype ==
                                                  torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype ==
                                                  torch.bfloat16 else b), name

    # the port writes, the reference reads
    ck = Checkpointer(TieredCheckpointStore(str(tmp_path / "port"), host_id=0))
    ck.save_blocking(5, {"params": tree_from_params(params)})
    ck.close()
    loaded = JStore(str(tmp_path / "port"), host_id=0).load(5)
    same_bits(loaded["params"], jtree)
    assert jax.tree.structure(loaded["params"]) == jax.tree.structure(jtree)
    assert loaded["params"]["tok_emb"].dtype == jnp.bfloat16

    files = [(tmp_path / side / "step_00000005" / "file_0.bin").read_bytes()
             for side in ("ref", "port")]
    assert files[0] == files[1]
    mans = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000005" / "host0.manifest.json") as f:
            mans.append([{k: leaf[k] for k in ("path", "offset", "nbytes", "dtype", "shape")}
                         for leaf in json.load(f)["leaves"]])
    assert mans[0] == mans[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_is_the_reference_layout(arch, tmp_path):
    cfg = get_smoke_config(arch)
    model = get_model(cfg, "cpu")
    params = model.init_params(0)
    store = TieredCheckpointStore(str(tmp_path))
    Checkpointer(store).save_blocking(1, {"params": tree_from_params(params)})
    specs = model.param_specs()
    want = {f"params/{k}": v for k, v in specs.items() if k != "layers"}
    want.update({f"params/layers/{k}": v for k, v in specs["layers"].items()})
    with open(store.manifest_path(1)) as f:
        got = {leaf["path"]: (tuple(leaf["shape"]), leaf["dtype"])
               for leaf in json.load(f)["leaves"]}
    dtypes = {"A_log": "float32"}
    assert got == {path: (shape, dtypes.get(path.rsplit("/", 1)[-1], "bfloat16"))
                   for path, shape in want.items()}


class _HeldStore(TieredCheckpointStore):
    """A store whose writes wait until the test releases them."""

    def __init__(self, root):
        super().__init__(root)
        self.release = threading.Event()

    def save(self, step, tree, **kw):
        assert self.release.wait(60)
        return super().save(step, tree, **kw)


def test_save_async_snapshot_is_isolated(tmp_path):
    """Parameters changed in place after ``save_async`` returns (the next
    AdamW step) do not reach the checkpoint, though it is written later."""

    cfg = get_smoke_config("qwen3-1.7b")
    params = get_model(cfg, "cpu").init_params(0)
    before = {k: v.clone() for k, v in tree_from_params(params).items() if k != "layers"}
    store = _HeldStore(str(tmp_path))
    ck = Checkpointer(store)
    top = {k: v for k, v in tree_from_params(params).items() if k != "layers"}
    ck.save_async(1, {"params": top})
    with torch.no_grad():
        for t in params.parameters():
            t.add_(1.0)
    assert ck.saves_completed == 0
    store.release.set()
    ck.wait()
    assert ck.saves_started == ck.saves_completed == 1 and len(ck.save_seconds) == 1
    _, restored = ck.restore_latest()
    ck.close()
    same_bits(restored["params"], before)
    assert not torch.equal(params.tok_emb, before["tok_emb"])


def test_one_save_in_flight_and_restore_cast(tmp_path):
    store = TieredCheckpointStore(str(tmp_path))
    ck = Checkpointer(store)
    assert ck.restore_latest() is None
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ck.save_async(1, {"w": w, "n": np.int32(7)})
    ck.save_async(2, {"w": w * 2, "n": np.int32(8)})  # waits for the first
    ck.wait()
    assert ck.saves_completed == 2 and store.latest_step() == 2
    step, out = ck.restore_latest(like={"w": torch.empty(12, dtype=torch.bfloat16,
                                                         device="meta")})
    assert step == 2 and set(out) == {"w"}
    assert out["w"].dtype == torch.bfloat16 and out["w"].shape == (12,)
    assert torch.equal(out["w"], (w * 2).reshape(12).to(torch.bfloat16))
    step, out = ck.restore_latest()
    assert isinstance(out["n"], torch.Tensor) and int(out["n"]) == 8
    ck.close()
