"""The port's sharded steps of the ssm, hybrid and encoder-decoder families
(and the one-hot embedding) against the reference's unsharded steps.

On real 4-rank ``gloo`` meshes, (2, 2) ``("data", "model")`` and (1, 2, 2)
``("pod", "data", "model")``, one train step (loss, grad_norm, the updated
weights), the prefill logits and three greedy decode steps of the smoke
falcon-mamba-7b (``ssm_impl`` torch; ``"kernel"``, whose prefill reaches
``ssm_scan_op``'s plain version through ``local_map``; and
``mamba_fused_proj``), zamba2-2.7b, whisper-tiny and qwen3-1.7b with
``embed_onehot``, with DTensor parameters, state, batch and cache, equal
the reference's unsharded steps on the same weights (the kernel case the
reference's torch-path scan: the kernel computes the same scan), in f32, at
the tolerances of ``tests/test_torch_sharding.py``: loss and grad_norm at
rtol 1e-5, weights at atol 1e-5 / rtol 1e-4, logits at atol / rtol 1e-4.

``restore_latest(shardings=)`` on those meshes restores a zamba2-2.7b
checkpoint that the reference's ``Checkpointer`` wrote in its (G, E)-stacked
layout, each rank's local shard equal to its slice of the leaf.

Every process group starts in a spawned child, never in the test process.
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import TieredCheckpointStore as JaxStore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import get_model as jax_get_model
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import init_state as jax_init_state
from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore
from repro_torch.distributed.sharding import placements_for
from repro_torch.models import stacked_param_axes
from repro_torch.models.convert import config_from_jax
from repro_torch.testing.sharded import sharded_steps, spawn_world

# case -> (arch, config overrides on both packages, the port's ssm_impl for
# serving): the kernel case serves through the scan kernel's op and trains
# on the torch path, as the reference trains
STEP_CASES = {"falcon-mamba-7b": ("falcon-mamba-7b", {}, "torch"),
              "falcon-mamba-7b-kernel": ("falcon-mamba-7b", {}, "kernel"),
              "falcon-mamba-7b-fused": ("falcon-mamba-7b", {"mamba_fused_proj": True}, "torch"),
              "zamba2-2.7b": ("zamba2-2.7b", {}, "torch"),
              "whisper-tiny": ("whisper-tiny", {}, "torch"),
              "qwen3-1.7b-onehot": ("qwen3-1.7b", {"embed_onehot": True}, "torch")}
RESTORE_CASE, RESTORE_STEP = "zamba2-2.7b", 5
MESH_SHAPES = {"2x2": ((2, 2), ("data", "model")),
               "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
B, S, DECODE, LR = 4, 16, 3, 1e-3
SELF_CACHES = ("k", "v", "attn_k", "attn_v")  # the caches a decode step grows


def _configs(case):
    arch, overrides, impl = STEP_CASES[case]
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               attention_impl="xla", ssm_impl="xla", **overrides)
    return jcfg, dataclasses.replace(config_from_jax(jcfg), ssm_impl=impl)


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """Weights, batch and the reference's unsharded steps."""

    jcfg, tcfg = _configs(case)
    jm = jax_get_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    if jcfg.family == "encdec":
        jb["frames"] = jnp.asarray(
            rng.standard_normal((B, jcfg.n_frames, jcfg.d_model)).astype(np.float32))
    new, _, metrics = jax_train_step(jm, JaxAdamW(lr=LR))(params, jax_init_state(params), jb)
    prompt = {k: v for k, v in jb.items() if k != "labels"}
    logits, cache = jm.prefill(new, prompt)
    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": jax.tree.map(np.asarray, new), "prefill_logits": np.asarray(logits),
            "decode_logits": []}
    cache = {k: jnp.pad(v, [(0, DECODE) if i == 2 else (0, 0) for i in range(v.ndim)])
             if k in SELF_CACHES else v for k, v in cache.items()}
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    for i in range(DECODE):
        logits, cache = jm.decode_step(new, cache, tok, jnp.int32(S + i))
        want["decode_logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    tree = jax.tree.map(np.asarray, params)
    batch = {k: torch.from_numpy(np.array(v)).long() if k in ("tokens", "labels")
             else torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return tcfg, tree, batch, want


def _on_mesh(shape, names, cases, restore_cfg, ckpt_root) -> dict:
    """Runs on each rank: every case's sharded steps (whole results on every
    rank), then each rank's restore of the checkpoint under ``ckpt_root``
    (the leaves of ``restore_cfg``) with its check of every local shard."""

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    out = {case: sharded_steps(cfg, tree, batch, mesh, decode_steps=DECODE, lr=LR)
           for case, cfg, tree, batch in cases}
    ckpt = Checkpointer(TieredCheckpointStore(ckpt_root))
    whole = TieredCheckpointStore(ckpt_root).load(RESTORE_STEP)["params"]
    shardings = {"params": {
        k: ({kk: (mesh, placements_for(np.shape(whole[k][kk]), a, mesh)) for kk, a in v.items()}
            if isinstance(v, dict) else (mesh, placements_for(np.shape(whole[k]), v, mesh)))
        for k, v in stacked_param_axes(restore_cfg).items()}}
    step, restored = ckpt.restore_latest(shardings=shardings)
    checked, split = 0, 0
    for k, v in restored["params"].items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            full = torch.from_numpy(np.array(whole[k][kk] if kk else whole[k]))
            # the slice of the leaf that DTensor's layout gives this rank
            lshape, offset = compute_local_shape_and_global_offset(full.shape, mesh,
                                                                   leaf.placements)
            want = full[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
            assert torch.equal(leaf.to_local(), want), (k, kk)
            checked += 1
            split += tuple(lshape) != tuple(full.shape)
    ckpt.close()
    return {"steps": out, "restored_leaves": checked, "split_leaves": split, "step": step}


@functools.lru_cache(maxsize=None)
def _mesh_results(mesh_key: str) -> list:
    cases = [(case, *_reference(case)[:3]) for case in STEP_CASES]
    with tempfile.TemporaryDirectory() as tmp:
        store = JaxCheckpointer(JaxStore(f"{tmp}/ckpt"))
        store.save_blocking(RESTORE_STEP, {"params": _reference(RESTORE_CASE)[1]})
        store.close()
        shape, names = MESH_SHAPES[mesh_key]
        return spawn_world(4, tmp, _on_mesh, shape, names, cases, _reference(RESTORE_CASE)[0],
                           f"{tmp}/ckpt", timeout=1200)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mesh_key", list(MESH_SHAPES))
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_steps_equal_the_reference(case, mesh_key):
    results = _mesh_results(mesh_key)
    want = _reference(case)[3]
    for got in (r["steps"][case] for r in results):  # every rank gathers the same
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=1e-5)
        ref_params = _flat(want["params"])
        assert set(got["params"]) == set(ref_params)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), ref_params[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(got["prefill_logits"].numpy(), want["prefill_logits"],
                                   atol=1e-4, rtol=1e-4)
        assert len(got["decode_logits"]) == DECODE
        for g, w in zip(got["decode_logits"], want["decode_logits"], strict=True):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mesh_key", list(MESH_SHAPES))
def test_hybrid_restore_with_shardings_gives_each_rank_its_slice(mesh_key):
    results = _mesh_results(mesh_key)
    n_leaves = len(_flat(_reference(RESTORE_CASE)[1]))
    assert [r["restored_leaves"] for r in results] == [n_leaves] * 4
    assert all(r["split_leaves"] > 0 for r in results)  # the layout splits some leaves
    assert all(r["step"] == RESTORE_STEP for r in results)
