"""The port's tensor sharding against the reference's.

(a) ``spec_for`` of every parameter, optimizer-state, cache and input leaf
    of the ten archs equals the reference's on both production meshes
    (duck-typed meshes, as ``tests/test_distributed.py``), with
    ``grok_decode``'s ``shard_rules_override`` too; each leaf's local shard
    under ``placements_for`` on a ``DeviceMesh`` of a fake world of 512
    ranks has the reference spec's shard shape (a per-layer leaf: the
    stacked leaf's without its depth dims); and the port's layout axes
    are the reference's ``param_axes``.
(d) On real 4-rank ``gloo`` meshes, (2, 2) ``("data", "model")`` and
    (1, 2, 2) ``("pod", "data", "model")``, one train step (loss,
    grad_norm, the updated weights), the prefill logits and three greedy
    decode steps of the smoke qwen3-1.7b (also with ``microbatch=2``, and
    with gradient compression),
    moonshot-v1-16b-a3b and internvl2-26b with DTensor parameters, state,
    batch and cache equal the
    reference's unsharded steps on the same weights, in f32: loss and
    grad_norm at rtol 1e-5, weights at atol 1e-5 / rtol 1e-4 (Adam
    normalises each gradient, so an update carries the gradient's relative
    error: the sharded step sums its products in another order), logits at
    atol / rtol 1e-4.
(e) ``restore_latest(shardings=)`` on those meshes restores a checkpoint
    that the reference's ``Checkpointer`` wrote, each rank's local shard
    equal to its slice of the leaf.

Every process group (the fake world and ``gloo``) starts in a spawned
child, never in the test process.
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
from repro.configs import applicable_cells as jax_applicable_cells
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.sharding import spec_for as jax_spec_for
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import get_model as jax_get_model
from repro.models import input_axes as jax_input_axes
from repro.models import input_specs as jax_input_specs
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import CompressionConfig as JaxCompression
from repro.optim import abstract_state as jax_abstract_state
from repro.optim import init_state as jax_init_state
from repro.optim import state_axes as jax_state_axes
from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore
from repro_torch.configs import ARCHITECTURES, SHAPE_CELLS, applicable_cells, get_config
from repro_torch.distributed.sharding import placements_for, spec_for
from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_world
from repro_torch.models import (get_model, input_axes, input_specs, named_param_axes,
                                stacked_param_axes)
from repro_torch.models.convert import config_from_jax
from repro_torch.optim import CompressionConfig, abstract_state, state_axes
from repro_torch.testing.sharded import sharded_steps, spawn_world


class FakeMesh:
    """Duck-typed mesh: spec_for only reads .shape (a dict)."""

    def __init__(self, **axes):
        self.shape = axes


def local_shape(shape, spec, mesh) -> tuple:
    """One device's shard shape of ``shape`` under the reference's spec."""

    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(dim // n)
    return tuple(out)


MESHES = {kind: FakeMesh(**dict(zip(names, shape)))
          for kind, (shape, names) in PRODUCTION_SHAPES.items()}
GROK_DECODE = {"batch": ()}  # hillclimb's grok_decode override


def _leaves(arch: str):
    """(key, port shape, port axes, reference shape, reference axes, depth
    dims to drop) for every param, optimizer-state, cache and input leaf."""

    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jmodel = get_model(cfg, "cpu"), jax_get_model(jcfg)
    params = model.abstract_params()
    axes = named_param_axes(cfg, params)
    jparams, jaxes = jmodel.abstract_params(), jmodel.param_axes()
    out = []
    for name, t in params.named_parameters():
        parts = name.split(".")
        if len(parts) == 1:
            ref, drop = (jparams[name], jaxes[name]), 0
        elif parts[0] == "shared":
            ref, drop = (jparams["shared"][parts[1]], jaxes["shared"][parts[1]]), 0
        else:
            stack = "mamba" if cfg.family == "hybrid" else parts[0]
            drop = 2 if stack == "mamba" else 1
            ref = (jparams[stack][parts[2]], jaxes[stack][parts[2]])
        out.append((f"param:{name}", tuple(t.shape), axes[name], tuple(ref[0].shape), ref[1],
                    drop))
    # optimizer state: the moments take the params' axes; step is replicated
    flat = dict(params.named_parameters())
    state, saxes = abstract_state(flat), state_axes(axes)
    jstate = jax_abstract_state(jparams)
    jsaxes = jax_state_axes(jaxes)
    assert saxes["step"] == jsaxes["step"] == ()
    out.append(("state:step", tuple(state["step"].shape), saxes["step"],
                tuple(jstate["step"].shape), jsaxes["step"], 0))
    for moment in ("m", "v"):
        for name, t in state[moment].items():
            p = next(l for l in out if l[0] == f"param:{name}")
            out.append((f"state:{moment}:{name}", tuple(t.shape), saxes[moment][name],
                        *p[3:]))
    cells = applicable_cells(cfg)
    assert cells == jax_applicable_cells(jcfg)
    for cell_name in cells:
        cell = SHAPE_CELLS[cell_name]
        if cell.kind == "decode":
            cache, caxes = model.abstract_cache(cell.global_batch, cell.seq_len), model.cache_axes()
            jcache = jmodel.abstract_cache(cell.global_batch, cell.seq_len)
            jcaxes = jmodel.cache_axes()
            for k, t in cache.items():
                out.append((f"cache:{cell_name}:{k}", tuple(t.shape), caxes[k],
                            tuple(jcache[k].shape), jcaxes[k], 0))
        specs, iaxes = input_specs(cfg, cell.kind, cell.global_batch, cell.seq_len), \
            input_axes(cfg, cell.kind)
        jspecs = jax_input_specs(jcfg, cell.kind, cell.global_batch, cell.seq_len)
        jiaxes = jax_input_axes(jcfg, cell.kind)
        assert set(specs) == set(jspecs) and iaxes == jiaxes
        for k, t in specs.items():
            out.append((f"input:{cell_name}:{k}", tuple(t.shape), iaxes[k],
                        tuple(jspecs[k].shape), jiaxes[k], 0))
    return out


def _local_shapes(mesh_kind: str, leaves: list) -> list:
    """Each ``(shape, axes, rules)`` leaf's local shard shape on rank 0 of
    the production mesh, from DTensor itself (runs in a spawned child)."""

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type="cpu")
        out = []
        for shape, axes, rules in leaves:
            t = torch.empty(shape, device="meta")
            pl = placements_for(shape, axes, mesh, rules)
            out.append(tuple(distribute_tensor(t, mesh, pl, src_data_rank=None)
                             .to_local().shape))
        return out


CASES = [(arch, kind, None) for arch in ARCHITECTURES for kind in MESHES] + [
    ("grok-1-314b", kind, "grok_decode") for kind in MESHES]


@functools.lru_cache(maxsize=None)
def _dtensor_shapes(mesh_kind: str) -> dict:
    """(shape, axes, rules) -> DTensor's local shape, for every distinct leaf
    of the cases on ``mesh_kind`` (the layers of a stack repeat theirs)."""

    leaves = set()
    for arch, kind, override in CASES:
        if kind == mesh_kind:
            rules = _rules_key(GROK_DECODE if override else {})
            leaves.update((leaf[1], leaf[2], rules) for leaf in _leaves(arch))
    leaves = sorted(leaves, key=repr)
    with tempfile.TemporaryDirectory() as tmp:
        shapes = spawn_world(1, tmp, _local_shapes, mesh_kind,
                             [(sh, ax, dict(r)) for sh, ax, r in leaves], group=False)[0]
    return dict(zip(leaves, shapes))


def _rules_key(override: dict) -> tuple:
    return tuple(sorted({**_default_rules(), **override}.items()))


def _default_rules():
    from repro_torch.distributed.sharding import DEFAULT_RULES

    return dict(DEFAULT_RULES)


@pytest.mark.parametrize("arch,mesh_kind,override", CASES,
                         ids=lambda v: str(v) if v is not None else "default")
def test_spec_and_local_shard_match_the_reference(arch, mesh_kind, override):
    mesh = MESHES[mesh_kind]
    rules = {**_default_rules(), **(GROK_DECODE if override else {})}
    assert stacked_param_axes(get_config(arch)) == jax_get_model(jax_config(arch)).param_axes()
    local = _dtensor_shapes(mesh_kind)
    leaves = _leaves(arch)
    assert len(leaves) > 10
    for key, shape, axes, ref_shape, ref_axes, drop in leaves:
        ref_spec = tuple(jax_spec_for(ref_shape, ref_axes, mesh, rules))
        assert ref_axes[drop:] == axes and ref_shape[drop:] == shape, key
        assert all(s is None for s in ref_spec[:drop]), key
        spec = spec_for(shape, axes, mesh, rules)
        assert spec == ref_spec[drop:], (key, spec, ref_spec)
        want = local_shape(ref_shape, ref_spec, mesh)[drop:]
        got = local[(shape, axes, _rules_key(GROK_DECODE if override else {}))]
        assert got == want, (key, got, want)


def test_out_of_mesh_order_rule_is_refused(tmp_path):
    mesh = MESHES["multi"]
    assert spec_for((256, 8), ("batch", None), mesh, {"batch": ("data", "pod")}) == \
        (("data", "pod"), None)
    out = spawn_world(1, str(tmp_path), _refused_out_of_order, group=False)[0]
    assert out.startswith("ValueError") and "mesh's order" in out


def _refused_out_of_order() -> str:
    from repro_torch.launch.mesh import make_production_mesh

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        try:
            placements_for((256, 8), ("batch", None), mesh, {"batch": ("data", "pod")})
        except ValueError as e:
            return f"ValueError: {e}"
        return "accepted"


# ---------------------------------------------------------------------------
# (d), (e): steps and restore on real 4-rank gloo meshes
# ---------------------------------------------------------------------------

# case -> (arch, config overrides, gradient compression); the microbatched
# step splits each rank's rows, where the reference takes contiguous rows of
# the batch: the same gradient sums; compression scales each row of a
# gradient by its max, which DTensor all-reduces where the row is split
STEP_CASES = {"qwen3-1.7b": ("qwen3-1.7b", {}, False),
              "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}, False),
              "internvl2-26b": ("internvl2-26b", {}, False),
              "qwen3-1.7b-microbatch2": ("qwen3-1.7b", {"microbatch": 2}, False),
              "qwen3-1.7b-compressed": ("qwen3-1.7b", {}, True)}
MESH_SHAPES = {"2x2": ((2, 2), ("data", "model")),
               "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
B, S, DECODE, LR = 4, 16, 3, 1e-3


def _configs(case):
    arch, overrides, _ = STEP_CASES[case]
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               attention_impl="xla", ssm_impl="xla", **overrides)
    return jcfg, config_from_jax(jcfg)


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """Weights, batch and the reference's unsharded steps."""

    jcfg, tcfg = _configs(case)
    jm = jax_get_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    if jcfg.family == "vlm":
        jb["patch_embeds"] = jnp.asarray(
            rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)).astype(np.float32))
    comp = JaxCompression(enabled=STEP_CASES[case][2])
    new, _, metrics = jax_train_step(jm, JaxAdamW(lr=LR), comp)(params, jax_init_state(params),
                                                                 jb)
    prompt = {k: v for k, v in jb.items() if k != "labels"}
    logits, cache = jm.prefill(new, prompt)
    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": jax.tree.map(np.asarray, new), "prefill_logits": np.asarray(logits),
            "decode_logits": []}
    cache = {k: jnp.pad(v, [(0, DECODE) if i == 2 else (0, 0) for i in range(v.ndim)])
             for k, v in cache.items()}
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    for i in range(DECODE):
        logits, cache = jm.decode_step(new, cache, tok, S + i)
        want["decode_logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    tree = jax.tree.map(np.asarray, params)
    batch = {k: torch.from_numpy(np.array(v)).long() if k != "patch_embeds"
             else torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return tcfg, tree, batch, want


def _on_mesh(shape, names, cases, ckpt_root) -> dict:
    """Runs on each rank: every case's sharded steps (whole results on rank
    0), then each rank's restore of the checkpoint under ``ckpt_root``."""

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    out = {case: sharded_steps(cfg, tree, batch, mesh, decode_steps=DECODE, lr=LR,
                               compression=CompressionConfig(enabled=STEP_CASES[case][2]))
           for case, cfg, tree, batch in cases}
    arch, cfg, tree, _ = cases[0]
    axes = stacked_param_axes(cfg)
    shardings = {"params": {k: ({kk: (mesh, placements_for(tree[k][kk].shape, a, mesh))
                                 for kk, a in v.items()} if isinstance(v, dict)
                                else (mesh, placements_for(tree[k].shape, v, mesh)))
                            for k, v in axes.items()}}
    ckpt = Checkpointer(TieredCheckpointStore(ckpt_root))
    step, restored = ckpt.restore_latest(shardings=shardings)
    whole = TieredCheckpointStore(ckpt_root).load(step)["params"]
    checked = 0
    for k, v in restored["params"].items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            full = torch.from_numpy(np.array(whole[k][kk] if kk else whole[k]))
            # the slice of the leaf that DTensor's layout gives this rank
            lshape, offset = compute_local_shape_and_global_offset(full.shape, mesh,
                                                                   leaf.placements)
            want = full[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
            assert torch.equal(leaf.to_local(), want), (k, kk)
            checked += 1
    ckpt.close()
    return {"steps": out, "restored_leaves": checked, "step": step}


@functools.lru_cache(maxsize=None)
def _mesh_results(mesh_key: str) -> list:
    cases = [(case, *_reference(case)[:3]) for case in STEP_CASES]
    with tempfile.TemporaryDirectory() as tmp:
        store = JaxCheckpointer(JaxStore(f"{tmp}/ckpt"))
        store.save_blocking(7, {"params": cases[0][2]})
        store.close()
        shape, names = MESH_SHAPES[mesh_key]
        return spawn_world(4, tmp, _on_mesh, shape, names, cases, f"{tmp}/ckpt", timeout=900)


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
    got = _mesh_results(mesh_key)[0]["steps"][case]
    want = _reference(case)[3]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=1e-5)
    ref_params = _flat(want["params"])
    assert set(got["params"]) == set(ref_params)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), ref_params[k], atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["prefill_logits"].numpy(), want["prefill_logits"],
                               atol=1e-4, rtol=1e-4)
    for g, w in zip(got["decode_logits"], want["decode_logits"], strict=True):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mesh_key", list(MESH_SHAPES))
def test_restore_with_shardings_gives_each_rank_its_slice(mesh_key):
    results = _mesh_results(mesh_key)
    n_leaves = len(_flat(_reference("qwen3-1.7b")[1]))
    assert [r["restored_leaves"] for r in results] == [n_leaves] * 4
    assert all(r["step"] == 7 for r in results)


def test_one_device_mesh_matches_plain_steps():
    """Without a mesh the helper runs the plain steps: the port's unsharded
    steps equal the reference's at the same tolerances."""

    tcfg, tree, batch, want = _reference("qwen3-1.7b")
    got = sharded_steps(tcfg, tree, batch, None, decode_steps=DECODE, lr=LR)
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["prefill_logits"].numpy(), want["prefill_logits"],
                               atol=1e-4, rtol=1e-4)
